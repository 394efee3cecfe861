// A serial region's k-mer call, sample_only_kmers, as one kernel for Hopper
// (sm_90a): one block, or a thread-block cluster of C CTAs (C = 2, 4, 8 or
// 16) on C SMs that write into each other's shared memory (distributed
// shared memory, DSMEM). It computes the sample's k-mer codes, their
// distinct values and counts, less every value of the reference (both
// strands) and of the matched normal, kept where the count reaches
// min_count.
//
// Replaces no Pallas kernel: it replaces the host composite
// breakmer_tpu/ops/kmer.py:190-235 (sample_only_kmers), which chains the
// jitted kmer_codes (three times), sort_kmers, unique_counts_sorted, the
// reference's both-strand table and its sort, and subtract_sorted, one XLA
// program each. The port ran that chain as K1-K4 of csrc/kmer.cu and three
// torch.sort calls: 30 CUDA kernels and 33 copies a call. The plain version
// is breakmer_tpu_torch/ops/kmer.py::sample_only_kmers_plain (the chain of
// the plain functions); the wrapper is ops/kmer_cuda.py::region_kmers, and
// ops/kmer.py routes a region here when kmer_cuda.region_plan says it fits
// (the plan also picks C, from the shapes and the card alone).
//
// What bounds it: neither bytes (a region's ~40 KB in and a few KB out)
// nor the card's operations; each CTA's passes over its shared memory, its
// block barriers and, across the cluster, the exchanges. On an NVIDIA H100
// 80GB HBM3 at 700 W (tools/kmer_time.py; PERF.md, section 6), at 200
// reads of 100 bases with a reference of 1,800 and a normal of 160 reads,
// one block takes ~87 us (the sort 58 % of it) and 16 CTAs ~43 us; one
// block is the faster below ~30 reads. On that card a cluster barrier with
// release semantics fences the whole card (MEMBAR.ALL.GPU in the SASS) and
// costs far more than a relaxed one, scattered 4-byte DSMEM accesses run
// far slower than consecutive ones, and a chain of dependent DSMEM loads
// far slower than in local shared memory. So the CTAs never search each
// other's memory and meet at two barriers: every exchange is a push
// (st.async into a peer's shared memory, its bytes counted on an mbarrier
// there, which the peer awaits).
//
// Design. The host packs every input into one pinned buffer (one copy to
// the card) and reads one result buffer back (one copy): the kept runs,
// the runs, then (value, count) pairs ascending by value. Each CTA of
// 1,024 threads holds, in dynamic shared memory (the layout is
// region_layout below, mirrored by kmer_cuda.region_smem_bytes):
//   X  a stage and scratch of x_lines 16-byte lines (at least its rows'
//      windows + 1 words, and a row's bytes);
//   S  the CTA's sample codes: first those it computed, after the sort its
//      rank range of the sorted codes;
//   B  a bit a slot of S (the slot's value lies in the reference or the
//      normal);
//   O  32 x 256 uint16 digit offsets, a warp's row each (the sort);
//   M  words for scans, counters, the mbarriers and the exchanged tables,
//      then the C CTAs' 256 digit totals.
// 1. Codes. CTA r takes the r-th C-th of the sample's rows. A set's rows
//    are staged in X, as many whole rows at a time as fit, with 16-byte
//    loads; each thread then takes consecutive windows of one staged row
//    (1,024 / rows threads a row, or, past 1,024 rows, whole rows): k steps
//    at its first window, all threads at once, then one shift, or and mask
//    a window (the rolling code of csrc/kmer.cu's kmer_codes_kernel, with
//    its direct uint32 code for a window that holds a negative byte). A
//    valid code that is not SENTINEL is appended to S, a warp's appends
//    placed by one shared atomic. C > 1: the CTA also computes the r-th C-th
//    of the reference's windows and of the normal's rows and appends their
//    valid codes to its part of a global scratch; the CTAs' counts and ORs
//    are pushed to every CTA: n codes in all, share = ceil(n / C) a CTA.
// 2. Sort. A stable LSD radix sort of passes of at most 8 bits (the bits
//    of the OR of all codes), partitioned by rank, never by value: CTA r
//    ends holding ranks [r share, (r + 1) share), whatever the data. In a
//    pass warp w of a CTA owns the w-th 32nd of the CTA's keys; it counts
//    its digits (shared atomic adds on its row of O, two uint16 counts a
//    word); thread t sums digit t / 4 over 8 warps and a 4-lane scan gives
//    each warp's offset within the CTA's digit and the CTA's digit total;
//    the keys are scattered by digit, stably, 32 at a time (a key's rank
//    among the lanes before it with its digit found by one match
//    instruction). One block scatters to the keys' ranks (2 or 4 passes,
//    between X and S). C > 1 (ceil(bits / 8) passes, at least one, so that
//    the keys reach their CTAs): the CTA scatters into X by digit, pushes
//    its 256 totals to every CTA, derives from the C rows a digit's global
//    base (its lower digits, and its keys in the CTAs before this one), and
//    pushes each key to its global rank g, slot g - c share of CTA c = g /
//    share (a digit's run of keys to consecutive slots), awaiting the keys
//    that are its own.
// 3. Membership. After the sort the CTAs push their first and last value,
//    the slots that hold the first and their key count to every CTA; O
//    takes an index of the CTA's keys, the first slot of each of 4,096
//    buckets of the keys' top 12 bits. A value is owned by the lowest CTA
//    whose [first, last] holds it (the CTA of its first slot). One block
//    stages the reference's rows, then the normal's, computes their codes
//    as in 1 and searches each (and each reference code's reverse
//    complement) in its bucket, by a branchless binary search; a found
//    value sets the bit of its first slot in B. C > 1: each CTA bins the
//    codes it stored in 1 (and the reference codes' reverse complements) by
//    their value's owner in the scratch; after the one cluster barrier with
//    release semantics (the scratch is global memory), each CTA loads its
//    bins from every CTA, eight loads in flight a thread, and searches
//    them so. Neither table is stored whole or sorted.
// 4. Runs. A slot starts a run where its value differs from the one
//    before (for a CTA's first slot: the last value of the CTA before);
//    each thread counts the starts of its consecutive slots, a block scan
//    places them, and X takes the start positions (and the CTA's count at
//    the end). The CTA holding a run's first slot owns it: the run of its
//    last start also counts the leading slots of the following CTAs that
//    hold its value.
// 5. Output. Each thread takes consecutive runs, keeps a run whose count
//    is at least min_count and whose start's bit is clear, and a block
//    scan, then the CTAs' pushed counts, place the kept (value, count)
//    pairs; CTA 0 writes the two counts. Every CTA awaits all it is sent,
//    so none leaves while a peer writes into it.
// C = 1 is one block launched as before, with no cluster barrier and no
// DSMEM access. k <= 0 runs the same phases, as the JAX functions take it:
// a window of no base has code 0 (valid where it lies in its read, nothing
// staged, no byte read), its reverse complement is 0, and the sort and the
// runs see one value; as the reference's windows are all valid, its code 0
// removes that value and the result is empty. A CTA's appended codes must
// stay below 65,536 (the uint16 offsets and index of O); ops/kmer.py takes
// the per-function route (K1-K4 and torch.sort) for a region whose layout
// fits at no cluster size the card runs, and the launch refuses one.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;          // digits of at most 8 bits
constexpr int MISC_WORDS = 672;    // M: the words below, then C x 256 digit totals
constexpr int MAX_KEYS = 65535;    // a CTA's appended codes: the uint16 offsets of O
constexpr int MAX_CLUSTER = 16;    // CTAs of a cluster (above 8 by the non-portable size)
constexpr int BUCKETS = 4096;      // the search index over S's top 12 bits, in O after the sort
constexpr int MAX_K = 15;
constexpr int PHASES = 11;         // clock stamps a CTA (Args::clocks)
constexpr uint32_t SENT = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
// M's words past the 32 warp sums
constexpr int M_KEYS = 32;    // this CTA's appended codes
constexpr int M_OR = 33;      // their OR
constexpr int M_SELF = 36;    // the keys of a pass that stay in this CTA
constexpr int M_TAIL = 37;    // the following CTAs' slots of this CTA's last run
constexpr int M_NREF = 38;    // this CTA's reference codes in the scratch
constexpr int M_NNORM = 39;   // and its normal codes
constexpr int M_BIN = 448;    // this CTA's routed codes a CTA owns, then their cursors (C words)
constexpr int M_BEFORE = 480; // this CTA's codes in the CTAs before CTA c's bins (C + 1 words)
constexpr int M_FROM = 512;   // where CTA c's bin for this CTA starts (C words)
constexpr int M_BARS = 40;    // five mbarriers (8 bytes each): the Bar enum's
constexpr int M_CODES = 416;  // each CTA's (codes, their OR)
constexpr int M_G = 64;       // 256 digit bases of this CTA, a pass
constexpr int M_INFO = 320;   // each CTA's (first value, last value, lead, keys held)
constexpr int M_KEPT = 384;   // each CTA's (runs, kept runs)
constexpr int M_TOT = MISC_WORDS;  // each CTA's 256 digit totals, a pass (C x 256)
enum Bar { TOTALS, KEYS, INFO, KEPT, CODES, BARS };

// The dynamic shared memory of a CTA: X's 16-byte lines, S's and B's words
// and the total in bytes (O and M at the end). R, W: the sample's rows and
// windows a row; longest: the longest row of the three sets, in bytes; C:
// the cluster's CTAs. rows: a CTA's sample rows at most; share: its sorted
// ranks at most.
struct Layout {
  long long x_lines, s_words, b_words, bytes, rows, share;
};

__host__ __device__ inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
__host__ __device__ inline long long round4(long long a) { return (a + 3) / 4 * 4; }

__host__ __device__ inline Layout region_layout(long long R, long long W, long long longest,
                                                int C) {
  Layout l;
  l.rows = ceil_div(R, C);
  l.share = ceil_div(R * W, C);
  const long long keys = ceil_div(l.rows * W + 1, 4), row = ceil_div(longest + 30, 16);
  l.x_lines = keys > row ? keys : row;
  l.s_words = round4(l.rows * W);
  l.b_words = round4(ceil_div(l.share, 32));
  l.bytes = 16 * l.x_lines + 4 * (l.s_words + l.b_words) + 2 * WARPS * BINS +
            4 * (MISC_WORDS + BINS * C);
  return l;
}

struct Set {
  const int8_t* codes;     // [R, L], rows at a stride of L
  const int32_t* lengths;  // [R]
  int R, L;
  int skip;  // windows of the row before codes (a part of a row): w <= length - skip - k
};

// C > 1: the global scratch of CTA r, `stride` words from scratch + r
// stride: a header (its reference and normal codes' counts, two words
// unused, then where its bin for each CTA c starts, C + 1 words, in
// HEADER words), its reference codes (ref_cap words), its normal codes
// (norm_cap words), then those codes and the reference's reverse
// complements binned by the CTA that owns their value.
constexpr int HEADER = 24;
struct Scratch {
  long long ref_cap, binned, stride;
};

__host__ __device__ inline Scratch region_scratch(long long W_r, long long R_n, long long W_n,
                                                  int C) {
  Scratch z;
  z.ref_cap = round4(ceil_div(W_r, C));
  const long long norm_cap = round4(ceil_div(R_n, C) * W_n);
  z.binned = HEADER + z.ref_cap + norm_cap;
  z.stride = C > 1 ? z.binned + 2 * z.ref_cap + norm_cap : 0;
  return z;
}

struct Args {
  Set sample, ref, normal;  // normal.codes null: no normal
  int k, min_count;
  int32_t* out;  // [2 + 2 cap]: kept pairs, runs, then (value, count) pairs
  long long cap;
  long long x_lines, s_words, b_words;
  long long* clocks;  // null, or [C, PHASES] clock64 stamps of each CTA's thread 0
  int32_t* scratch;   // C > 1: [C, z.stride] (region_scratch)
  Scratch z;
};

// CTA r's part of a set's rows, or (one row) of its windows.
__device__ Set rows_part(const Set& s, int r, int C) {
  const long long r0 = (long long)s.R * r / C, r1 = (long long)s.R * (r + 1) / C;
  Set p = s;
  p.codes += r0 * s.L;
  p.lengths += r0;
  p.R = (int)(r1 - r0);
  return p;
}

__device__ Set windows_part(const Set& s, int k, int r, int C) {
  const long long W = s.L - k + 1, w0 = W * r / C, w1 = W * (r + 1) / C;
  Set p = s;
  p.codes += k > 0 ? w0 : 0;     // (k <= 0: no byte is read, and W > L)
  p.L = (int)(w1 - w0) + k - 1;  // the part's W is w1 - w0
  p.skip = (int)w0;
  if (w1 == w0) p.R = 0;
  return p;
}

// Distributed shared memory by pushes: st.async writes into a peer CTA's
// shared memory and completes its bytes on an mbarrier there, which the
// peer waits on (no cluster barrier and no fence of the whole card).
__device__ __forceinline__ uint32_t local_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t peer_addr(const void* p, int c) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local_addr(p)), "r"(c));
  return r;
}

__device__ __forceinline__ void bar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(local_addr(b)));
}

// The one arrival of the barrier's phase, with the bytes it awaits.
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(local_addr(b)),
               "r"(bytes)
               : "memory");
}

// Waits for the barrier's phase of this parity to complete; every thread
// of the CTA waits, then meets at a block barrier (so none falls two
// phases behind).
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n@!done bra WAIT;\n}" ::"r"(
          local_addr(b)),
      "r"(parity)
      : "memory");
  __syncthreads();
}

__device__ __forceinline__ void push(uint32_t dst, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];" ::"r"(
                   dst),
               "r"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void push4(uint32_t dst, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.u32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// Threads t < 4 C, t / 4 != rank, push the 16 bytes at `mine` (this CTA's
// row of a table) to that row of CTA t / 4's table, on its barrier `bar`
// (words past the first `words` are not sent); thread 0 then awaits the
// same from the others, and every thread waits.
__device__ void exchange(const uint32_t* mine, int words, uint64_t* bar, int rank, int C) {
  const int t = threadIdx.x, c = t >> 2;
  if (t < 4 * C && (t & 3) == 0 && c != rank) {
    if (words == 4)
      push4(peer_addr(mine, c), *reinterpret_cast<const uint4*>(mine), peer_addr(bar, c));
    else
      for (int j = 0; j < words; ++j) push(peer_addr(mine + j, c), mine[j], peer_addr(bar, c));
  }
  if (t == 0) bar_expect(bar, (uint32_t)(4 * words * (C - 1)));
  bar_wait(bar, 0);
}

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

// The reverse complement of v's low 2k bits (csrc/kmer.cu's revcomp; v is
// never SENTINEL here): 0 at k <= 0.
__device__ __forceinline__ uint32_t revcomp(uint32_t v, int k) {
  constexpr uint64_t ODD = 0x5555555555555555ull;
  uint64_t y = __brevll((unsigned long long)v);
  y = ((y >> 1) & ODD) | ((y & ODD) << 1);
  return k > 0 ? (uint32_t)(~y >> (64 - 2 * k)) : 0u;
}

__device__ __forceinline__ unsigned lanes_below() { return (1u << (threadIdx.x & 31)) - 1; }

// The exclusive prefix of v over the block's threads in thread order, and
// the block's total; every thread calls it (three barriers).
__device__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = (warp ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[WARPS - 1];
  __syncthreads();  // (the sums are read: the next scan may write them)
  return before;
}

// The exclusive scan over the 256 digits of v (threads t < BINS hold
// digit t), into out[t]; every thread calls it (two barriers; m[0 .. 8)
// takes the warp sums).
__device__ void digit_scan(int v, int* out, int* m) {
  const int t = threadIdx.x, lane = t & 31;
  int x = v;
  if (t < BINS) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) m[t >> 5] = x;
  }
  __syncthreads();
  if (t < BINS) {
    int before = x - v;
    for (int w = 0; w < (t >> 5); ++w) before += m[w];
    out[t] = before;
  }
  __syncthreads();
}

// The lanes of the warp that hold `in` and the same digit d as this lane
// (one match instruction; a lane without `in` matches none).
__device__ __forceinline__ unsigned peers(uint32_t d, bool in) {
  return __match_any_sync(FULL, in ? d : 0x100u + (threadIdx.x & 31));
}

// The keys CTA c holds after the sort: its ranks [c share, (c + 1) share).
__device__ __forceinline__ int held(int n, int share, int c) {
  return max(0, min(share, n - c * share));
}

// Sorts the cluster's n keys ascending by their low `bits` bits (every key
// has no other bit set): this CTA's cnt keys start in keys[0 .. cnt) and
// its ranks [rank share, (rank + 1) share) end there; tmp is the other
// buffer. C = 1 (share = n): 2 or 4 passes of at most 8 bits, a key
// scattered to its rank in tmp and back, so they end in keys. C > 1: at
// least one pass (a pass of digit 0 where no bit sorts, so the keys reach
// the CTA of their ranks), ceil(bits / 8) passes; a pass scatters the
// CTA's keys by digit into tmp, locally, pushes the CTA's digit totals to
// every CTA, and then each key to its global rank in its CTA's keys.
template <bool MULTI>
__device__ void radix_sort(uint32_t* keys, uint32_t* tmp, int cnt, int n, int share, int bits,
                           uint16_t* offs, int* m, int rank, int C) {
  int passes = bits == 0 || n <= 1 ? 0 : MULTI ? (bits + 7) / 8 : bits <= 16 ? 2 : 4;
  const int width = passes ? (bits + passes - 1) / passes : 0;
  if (MULTI && passes == 0) passes = 1;  // the keys still go to their ranks' CTAs, digit 0
  if (passes == 0) return;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t dmask = (1u << width) - 1;
  int* const totals = m + M_TOT;  // [C][BINS]: row c is CTA c's (C = 1: this CTA's)
  int* const total = totals + (MULTI ? rank * BINS : 0);
  int* const base = m + M_G;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(m + M_BARS);
  uint16_t* mine = offs + warp * BINS;
  uint32_t* src = keys;
  uint32_t* dst = tmp;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * width;
    const int seg = (int)((ceil_div(cnt, WARPS) + 31) / 32 * 32);  // whole 32-key chunks a warp
    const int a = min(cnt, warp * seg), b = min(cnt, a + seg);
    // the warp's count of each digit: shared atomic adds to the uint16
    // halves of its row's words (a count stays below 65,536)
    for (int i = a + lane; i < b; i += 32) {
      const uint32_t d = (src[i] >> shift) & dmask;
      atomicAdd(reinterpret_cast<unsigned*>(mine + (d & ~1u)), 1u << (16 * (d & 1)));
    }
    __syncthreads();
    {  // thread t: digit t / 4 of warps 8 (t % 4) .. + 7; a warp's offset
       // within the CTA's digit, and the CTA's digit total
      const int d = t >> 2, w0 = (t & 3) * 8;
      int c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += c[j] = offs[(w0 + j) * BINS + d];
      int incl = s;
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o, 4);
        if ((t & 3) >= o) incl += y;
      }
      int at = incl - s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        offs[(w0 + j) * BINS + d] = (uint16_t)at;
        at += c[j];
      }
      if ((t & 3) == 3) total[d] = incl;
    }
    __syncthreads();
    // a digit's first slot: in the CTA (C > 1: the local scatter), or in
    // the sort (C = 1)
    digit_scan(t < BINS ? total[t] : 0, base, m);
    for (int c = a; c < b; c += 32) {  // the stable scatter
      const int i = c + lane;
      const bool in = i < b;
      const uint32_t key = in ? src[i] : 0;
      const uint32_t d = (key >> shift) & dmask;
      const unsigned same = peers(d, in);
      const int at = in ? mine[d] : 0;
      __syncwarp();
      if (in) {
        const unsigned before = same & lanes_below();
        dst[base[d] + at + __popc(before)] = key;
        if (before == 0) mine[d] = (uint16_t)(at + __popc(same));
      }
      __syncwarp();
    }
    for (int i = lane; i < BINS / 2; i += 32) reinterpret_cast<uint32_t*>(mine)[i] = 0;
    __syncthreads();
    if constexpr (MULTI) {
      // the CTAs' totals: this CTA's row pushed to every other CTA (16
      // bytes a thread), theirs awaited
      {
        const int c = t >> 6, j = 4 * (t & 63);
        if (c < C && c != rank)
          push4(peer_addr(total + j, c), *reinterpret_cast<const uint4*>(total + j),
                peer_addr(&bars[TOTALS], c));
        if (t == 0) bar_expect(&bars[TOTALS], (uint32_t)(4 * BINS * (C - 1)));
        bar_wait(&bars[TOTALS], p & 1);
      }
      // a digit's keys go from local slot i to global rank i + moved[d]:
      // the cluster's keys of lower digits and the digit's keys in the
      // CTAs before this one, less the digit's first local slot
      int tot = 0, below = 0;
      if (t < BINS) {
        for (int c = 0; c < C; ++c) {
          const int v = totals[c * BINS + t];
          tot += v;
          below += c < rank ? v : 0;
        }
      }
      const int local = t < BINS ? base[t] : 0;
      digit_scan(tot, base, m);
      if (t < BINS) base[t] += below - local;
      __syncthreads();
      int self = 0;
      for (int i = t; i < cnt; i += THREADS) {
        const uint32_t key = dst[i];
        const int g = i + base[(key >> shift) & dmask];
        const int owner = g / share;
        if (owner == rank) {
          src[g - owner * share] = key;
          ++self;
        } else {
          push(peer_addr(src + (g - owner * share), owner), key, peer_addr(&bars[KEYS], owner));
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) self += __shfl_xor_sync(FULL, self, o);
      if (lane == 0 && self) atomicAdd(&m[M_SELF], self);
      __syncthreads();
      if (t == 0) {
        bar_expect(&bars[KEYS], (uint32_t)(4 * (held(n, share, rank) - m[M_SELF])));
        m[M_SELF] = 0;
      }
      bar_wait(&bars[KEYS], p & 1);
      cnt = held(n, share, rank);
    } else {
      uint32_t* tt = src;
      src = dst;
      dst = tt;
    }
  }
}

// Where a membership search looks: this CTA's sorted keys s, its bucket
// index start and its bits.
struct Index {
  uint32_t* s;
  uint16_t* start;
  uint32_t* bits;
  int shift;
};

// Sets the bit of v's first slot, if v is among this CTA's keys: a
// branchless binary search of v's bucket [start[v >> shift], start[(v >>
// shift) + 1]) (a value past the last bucket is past every slot).
__device__ __forceinline__ void mark(const Index& ix, uint32_t v) {
  const uint32_t b = v >> ix.shift;
  if (b >= BUCKETS) return;
  int at = ix.start[b];
  const int end = ix.start[b + 1];
  if (at == end) return;
  for (int len = end - at; len > 1; len -= len >> 1) {
    const int half = len >> 1;
    at = ix.s[at + half] < v ? at + half : at;
  }
  at += ix.s[at] < v;
  if (at < end && ix.s[at] == v) atomicOr(&ix.bits[at >> 5], 1u << (at & 31));
}

enum Mode { APPEND, STORE, MARK_BOTH, MARK };

// Every window of a set, in chunks of whole rows staged in X: APPEND adds
// the sample's valid codes that are not SENTINEL to dst (shared memory;
// m[ctr] of them, m[M_OR] their OR), STORE a set's valid codes to dst (the
// global scratch; m[ctr] of them); MARK_BOTH marks each valid code of the
// reference and its reverse complement, MARK each valid code of the
// normal. Every thread of the CTA calls it; the windows a thread computes
// are consecutive. At k <= 0 a window holds no base: nothing is staged, no
// byte is read, and a window's code is 0 where it lies in its read (W = L
// - k + 1 exceeds L, which may be 0 or, in a part of the reference, less).
template <Mode MODE>
__device__ void each_window(const Set& set, int k, uint4* stage, long long stage_lines,
                            const Index& ix, int n, int* m, uint32_t* dst = nullptr,
                            int ctr = M_KEYS) {
  const int R = set.R, L = set.L, W = L - k + 1;
  if (R == 0 || ((MODE == MARK || MODE == MARK_BOTH) && n == 0)) return;
  const int lane = threadIdx.x & 31;
  const uint32_t mask = k > 0 ? (1u << (2 * k)) - 1 : 0;  // k <= 15
  const int roll_from = k > 0 ? 1 : INT_MAX;  // the first window that rolls a byte in
  // rows a chunk: >= 1 by the layout (k <= 0: every row, none staged)
  const int rows_per = k > 0 ? (int)((16 * stage_lines - 30) / L) : R;
  uint32_t orv = 0;
  for (int r0 = 0; r0 < R; r0 += rows_per) {
    const int r1 = min(R, r0 + rows_per);
    const uintptr_t lo = (uintptr_t)(set.codes + (long long)r0 * L);
    const uintptr_t hi = (uintptr_t)(set.codes + (long long)r1 * L);
    const uintptr_t base = lo & ~(uintptr_t)15;
    const int lines = k > 0 ? (int)((hi - base + 15) / 16) : 0;
    for (int q = threadIdx.x; q < lines; q += THREADS)
      stage[q] = reinterpret_cast<const uint4*>(base)[q];
    __syncthreads();
    const int8_t* bytes = reinterpret_cast<const int8_t*>(stage) + (lo - base);
    // a thread's windows never cross a row: with at most THREADS rows
    // staged, g threads a row take per consecutive windows each; with
    // more, a thread takes whole rows t, t + THREADS, ... So every
    // thread's k-step start comes before its loop, all at once.
    const int rows = r1 - r0;
    const int g = rows <= THREADS ? THREADS / rows : 1;
    const int per = (W + g - 1) / g;
    const int rounds = (rows + THREADS - 1) / THREADS;
    for (int round = 0; round < rounds; ++round) {
      const int r = rows <= THREADS ? threadIdx.x / g : round * THREADS + threadIdx.x;
      const bool has = r < rows;
      const int w0 = has ? (threadIdx.x % g) * per : 0, w1 = has ? min(W, w0 + per) : 0;
      const int8_t* row = bytes + (long long)(has ? r : 0) * L;
      // w <= length - k in wrapping int32, as the plain version computes it
      const int last = w0 < w1 ? (int)((uint32_t)set.lengths[r0 + r] - (uint32_t)set.skip -
                                       (uint32_t)k)
                               : 0;
      int bad_at = -1, neg_at = -1;  // the window's last byte >= 4 and < 0 so far
      uint32_t acc = 0;
      for (int j = 0; w0 < w1 && j < k; ++j) {  // the first window: k steps
        const int8_t x = row[w0 + j];
        if (x >= 4) bad_at = w0 + j;
        if (x < 0) neg_at = w0 + j;
        acc = (acc << 2) | (uint32_t)(x & 3);
      }
      for (int i = 0; i < per; ++i) {
        const int w = w0 + i;
        const bool in = w < w1;
        uint32_t code = SENT;
        if (in) {
          if (i >= roll_from) {  // roll the window's last byte in
            const int8_t x = row[w + k - 1];
            if (x >= 4) bad_at = w + k - 1;
            if (x < 0) neg_at = w + k - 1;
            acc = ((acc << 2) | (uint32_t)(x & 3)) & mask;
          }
          if (w <= last && bad_at < w) code = neg_at >= w ? window_code(row + w, k) : acc;
        }
        const bool keep = in && code != SENT;
        if constexpr (MODE == APPEND || MODE == STORE) {  // a warp's appends by one atomic
          const unsigned b = __ballot_sync(FULL, keep);
          int at = 0;
          if (lane == 0 && b) at = atomicAdd(&m[ctr], __popc(b));
          at = __shfl_sync(FULL, at, 0);
          if (keep) {
            dst[at + __popc(b & lanes_below())] = code;
            orv |= code;
          }
        } else if (keep) {
          mark(ix, code);
          if (MODE == MARK_BOTH) mark(ix, revcomp(code, k));
        }
      }
    }
    __syncthreads();  // the stage is read: the next chunk may fill it
  }
  if constexpr (MODE == APPEND) {
    for (int o = 16; o; o >>= 1) orv |= __shfl_xor_sync(FULL, orv, o);
    if (lane == 0 && orv) atomicOr(reinterpret_cast<unsigned*>(&m[M_OR]), orv);
    __syncthreads();
  }
}

template <bool MULTI>
__global__ void __launch_bounds__(THREADS) region_kmers_kernel(const Args args) {
  extern __shared__ uint4 smem[];
  uint4* stage = smem;
  uint32_t* x = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s = x + 4 * args.x_lines;
  uint32_t* bits = s + args.s_words;
  uint16_t* offs = reinterpret_cast<uint16_t*>(bits + args.b_words);
  int* m = reinterpret_cast<int*>(offs + WARPS * BINS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(m + M_BARS);
  const int t = threadIdx.x;
  int rank = 0, C = 1;
  if constexpr (MULTI) {
    rank = (int)cg::this_cluster().block_rank();
    C = (int)cg::this_cluster().num_blocks();
  }
  auto stamp = [&](int phase) {
    if (args.clocks != nullptr && t == 0) args.clocks[rank * PHASES + phase] = clock64();
  };

  for (long long i = t; i < args.b_words; i += THREADS) bits[i] = 0;
  for (int i = t; i < WARPS * BINS / 2; i += THREADS) reinterpret_cast<uint32_t*>(offs)[i] = 0;
  if (t < M_TOT) m[t] = 0;
  __syncthreads();
  if constexpr (MULTI) {  // every CTA's barriers initialised before any CTA pushes
    if (t == 0) {
      for (int b = 0; b < BARS; ++b) bar_init(&bars[b]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;" :::
                     "memory");
  }
  stamp(0);

  // 1: this CTA's rows' valid codes in S (C > 1: and its share of the
  // reference's windows and the normal's rows, their codes stored in its
  // scratch); then the cluster's count and OR
  Index ix{s, offs, bits, 0};
  each_window<APPEND>(rows_part(args.sample, rank, C), args.k, stage, args.x_lines, ix, 0, m,
                      s);
  int32_t* mine_scratch = args.scratch + rank * args.z.stride;
  if constexpr (MULTI) {
    each_window<STORE>(windows_part(args.ref, args.k, rank, C), args.k, stage, args.x_lines, ix,
                       0, m, (uint32_t*)mine_scratch + HEADER, M_NREF);
    if (args.normal.codes != nullptr)
      each_window<STORE>(rows_part(args.normal, rank, C), args.k, stage, args.x_lines, ix, 0, m,
                         (uint32_t*)mine_scratch + HEADER + args.z.ref_cap, M_NNORM);
    __syncthreads();
    if (t == 0) mine_scratch[0] = m[M_NREF], mine_scratch[1] = m[M_NNORM];
  }
  const int cnt = m[M_KEYS];
  int n = cnt;
  uint32_t orv = (uint32_t)m[M_OR];
  stamp(1);
  if constexpr (MULTI) {  // the CTAs' counts and ORs, exchanged
    uint32_t* codes = reinterpret_cast<uint32_t*>(m + M_CODES);  // [C][2]
    if (t == 0) codes[2 * rank] = (uint32_t)cnt, codes[2 * rank + 1] = orv;
    __syncthreads();
    exchange(codes + 2 * rank, 2, &bars[CODES], rank, C);
    n = 0;
    orv = 0;
    for (int c = 0; c < C; ++c) n += (int)codes[2 * c], orv |= codes[2 * c + 1];
  }
  stamp(2);

  // 2: the sort; this CTA then holds ranks [rank share, rank share + mine)
  const int key_bits = orv ? 32 - __clz(orv) : 0;
  const int share = MULTI ? (n + C - 1) / C : n;
  const int mine = MULTI ? held(n, share, rank) : n;
  radix_sort<MULTI>(s, x, cnt, n, share, key_bits, offs, m, rank, C);
  stamp(3);

  // each CTA's first and last value, the slots that hold its first value
  // and its keys, exchanged; then the search index in O: start[b], the
  // first slot whose top 12 bits are >= b; start[BUCKETS] = mine
  uint32_t* info = reinterpret_cast<uint32_t*>(m + M_INFO);  // [C][4]
  if constexpr (MULTI) {
    if (t == 0) {
      int lo = 1, hi = mine;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s[mid] == s[0]) lo = mid + 1; else hi = mid;
      }
      uint32_t* me = info + 4 * rank;
      me[0] = mine ? s[0] : 0;
      me[1] = mine ? s[mine - 1] : 0;
      me[2] = mine ? (uint32_t)lo : 0;
      me[3] = (uint32_t)mine;
    }
    __syncthreads();
    exchange(info + 4 * rank, 4, &bars[INFO], rank, C);
  }
  uint16_t* start = offs;
  const int shift = key_bits > 12 ? key_bits - 12 : 0;
  {  // the buckets before the first key's and after the last key's by all threads
    const int per = (mine + THREADS - 1) / THREADS;
    const int a = min(mine, t * per), b = min(mine, a + per);
    for (int i = max(a, 1); i < b; ++i) {
      const int hi = (int)(s[i] >> shift);
      for (int q = (int)(s[i - 1] >> shift) + 1; q <= hi; ++q) start[q] = (uint16_t)i;
    }
    for (int q = t; mine && q <= (int)(s[0] >> shift); q += THREADS) start[q] = 0;
    for (int q = (mine ? (int)(s[mine - 1] >> shift) + 1 : 0) + t; q <= BUCKETS; q += THREADS)
      start[q] = (uint16_t)mine;
  }
  __syncthreads();
  stamp(4);

  // 3: the reference's codes and reverse complements, then the normal's:
  // C = 1 computes them here. C > 1: each CTA bins the codes it stored
  // (and the reference's reverse complements) by the CTA that owns their
  // value, in the scratch; after a cluster barrier each CTA searches the
  // codes of its bins.
  ix.shift = shift;
  if constexpr (MULTI) {
    const int filled = share ? (n + share - 1) / share : 0;
    const int nref = m[M_NREF], items = 2 * nref + m[M_NNORM];
    const uint32_t* stored = reinterpret_cast<const uint32_t*>(mine_scratch) + HEADER;
    uint32_t* binned = reinterpret_cast<uint32_t*>(mine_scratch) + args.z.binned;
    int* const bin = m + M_BIN;
    // item i: a stored reference code, its reverse complement, or a stored
    // normal code; a value's owner: the lowest CTA whose [first, last]
    // holds it, or -1
    auto item = [&](int i) {
      return i < 2 * nref ? (i & 1 ? revcomp(stored[i >> 1], args.k) : stored[i >> 1])
                          : stored[args.z.ref_cap + (i - 2 * nref)];
    };
    auto owner = [&](uint32_t v) {
      int c = 0;
      for (int step = MAX_CLUSTER; step; step >>= 1)
        if (c + step <= filled && info[4 * (c + step - 1) + 1] < v) c += step;
      return c < filled && info[4 * c] <= v ? c : -1;
    };
    for (int pass = 0; pass < 2; ++pass) {  // count a CTA's items, then place them
      for (int i0 = (t & ~31); i0 < items; i0 += THREADS) {
        const int i = i0 + (t & 31);
        const uint32_t v = i < items ? item(i) : 0;
        const int o = i < items ? owner(v) : -2;
        const unsigned same = __match_any_sync(FULL, o);
        const int lead = __ffs(same) - 1;
        int at = 0;
        if ((t & 31) == lead && o >= 0) at = atomicAdd(&bin[o], __popc(same));
        at = __shfl_sync(FULL, at, lead) + __popc(same & lanes_below());
        if (pass && o >= 0) binned[at] = v;
      }
      __syncthreads();
      if (!pass && t == 0) {  // each bin's start, in this CTA's header and as its cursor
        int at = 0;
        for (int c = 0; c < C; ++c) {
          const int size = bin[c];
          mine_scratch[4 + c] = bin[c] = at;
          at += size;
        }
        mine_scratch[4 + C] = at;
      }
      __syncthreads();
    }
    stamp(5);
    cg::this_cluster().sync();  // every CTA's bins in the scratch
    stamp(6);
    if (t < 32) {  // where each CTA's bin for this CTA starts, and its codes before it
      int from = 0, size = 0;
      if (t < C) {
        const int32_t* z = args.scratch + t * args.z.stride;
        from = z[4 + rank];
        size = z[5 + rank] - from;
      }
      int x = size;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (t >= o) x += y;
      }
      if (t < C) m[M_FROM + t] = from;
      if (t <= C) m[M_BEFORE + t] = x - size;  // (lane C: the total)
    }
    __syncthreads();
    // the bins' codes as one run: eight loads in flight a thread
    constexpr int IN_FLIGHT = 8;
    const int* before = m + M_BEFORE;
    for (int f0 = t; f0 < before[C]; f0 += IN_FLIGHT * THREADS) {
      uint32_t v[IN_FLIGHT];
#pragma unroll
      for (int j = 0; j < IN_FLIGHT; ++j) {
        const int f = f0 + j * THREADS;
        v[j] = SENT;
        if (f < before[C]) {
          int c = 0;  // the CTA whose bin holds f
          for (int step = MAX_CLUSTER / 2; step; step >>= 1)
            if (c + step < C && before[c + step] <= f) c += step;
          v[j] = reinterpret_cast<const uint32_t*>(args.scratch)[
              c * args.z.stride + args.z.binned + m[M_FROM + c] + (f - before[c])];
        }
      }
#pragma unroll
      for (int j = 0; j < IN_FLIGHT; ++j)
        if (v[j] != SENT) mark(ix, v[j]);
    }
  } else {
    each_window<MARK_BOTH>(args.ref, args.k, stage, args.x_lines, ix, n, m);
    stamp(5);
    if (args.normal.codes != nullptr)
      each_window<MARK>(args.normal, args.k, stage, args.x_lines, ix, n, m);
    stamp(6);
  }
  __syncthreads();
  stamp(7);

  // 4: run starts into X; the slots of this CTA's last run in the CTAs after it
  int runs;
  {
    const int per = (mine + THREADS - 1) / THREADS;
    const int a = min(mine, t * per), b = min(mine, a + per);
    const bool first_starts = !MULTI || rank == 0 || (mine && s[0] != info[4 * (rank - 1) + 1]);
    int c = 0;
    for (int i = a; i < b; ++i) c += i ? s[i] != s[i - 1] : first_starts;
    int at = block_scan(c, m, &runs);
    for (int i = a; i < b; ++i)
      if (i ? s[i] != s[i - 1] : first_starts) x[at++] = (uint32_t)i;
    if (t == 0) {
      x[runs] = (uint32_t)mine;
      int tail = 0;
      if (MULTI && mine) {
        const uint32_t v = s[mine - 1];
        for (int c2 = rank + 1; c2 < C && info[4 * c2 + 3] && info[4 * c2] == v; ++c2) {
          tail += (int)info[4 * c2 + 2];
          if (info[4 * c2 + 2] < info[4 * c2 + 3]) break;
        }
      }
      m[M_TAIL] = tail;
    }
    __syncthreads();
  }
  stamp(8);

  // 5: the kept runs, ascending
  {
    const int tail = m[M_TAIL];
    const int per = (runs + THREADS - 1) / THREADS;
    const int a = min(runs, t * per), b = min(runs, a + per);
    int c = 0;
    for (int u = a; u < b; ++u) {
      const uint32_t i = x[u];
      const int count = (int)(x[u + 1] - i) + (u == runs - 1 ? tail : 0);
      c += count >= args.min_count && !((bits[i >> 5] >> (i & 31)) & 1);
    }
    int kept;
    long long at = block_scan(c, m, &kept);
    int all_kept = kept, all_runs = runs;
    if constexpr (MULTI) {  // the CTAs' runs and kept runs, exchanged
      uint32_t* counts = reinterpret_cast<uint32_t*>(m + M_KEPT);  // [C][2]
      if (t == 0) counts[2 * rank] = (uint32_t)runs, counts[2 * rank + 1] = (uint32_t)kept;
      __syncthreads();
      exchange(counts + 2 * rank, 2, &bars[KEPT], rank, C);
      int below = 0;
      all_kept = all_runs = 0;
      for (int c2 = 0; c2 < C; ++c2) {
        all_runs += (int)counts[2 * c2];
        all_kept += (int)counts[2 * c2 + 1];
        below += c2 < rank ? (int)counts[2 * c2 + 1] : 0;
      }
      at += below;
    }
    int2* pairs = reinterpret_cast<int2*>(args.out + 2);
    for (int u = a; u < b; ++u) {
      const uint32_t i = x[u];
      const int count = (int)(x[u + 1] - i) + (u == runs - 1 ? tail : 0);
      if (count >= args.min_count && !((bits[i >> 5] >> (i & 31)) & 1) && at < args.cap)
        pairs[at++] = make_int2((int)s[i], count);
    }
    if (rank == 0 && t == 0) args.out[0] = all_kept, args.out[1] = all_runs;
  }
  stamp(9);
  stamp(10);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

bool cluster_size(int C) { return C == 1 || C == 2 || C == 4 || C == 8 || C == MAX_CLUSTER; }

// The opt-in shared memory of a block on the current card, and both forms
// of the kernel let take it there (once a card).
int smem_optin() {
  static int limit[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (limit[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (v > 0 &&
        cudaFuncSetAttribute(region_kmers_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, v) == cudaSuccess &&
        cudaFuncSetAttribute(region_kmers_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, v) == cudaSuccess)
      limit[dev] = v;
  }
  return limit[dev];
}

// A launch configuration of C CTAs as one cluster (attr: its storage);
// the non-portable cluster size is allowed on the kernel when C is 16
// (once a card).
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int C,
                           size_t bytes, cudaStream_t stream) {
  static bool non_portable[64] = {};
  int dev = 0;
  if (C > 8 && (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64 ||
                !non_portable[dev])) {
    const cudaError_t e = cudaFuncSetAttribute(
        region_kmers_kernel<true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < 64) non_portable[dev] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)C, 1, 1);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

long long longest_row(int L_s, int L_r, int ln) {
  return L_s > L_r ? (L_s > ln ? L_s : ln) : (L_r > ln ? L_r : ln);
}

}  // namespace

extern "C" {

// The global scratch a launch of C CTAs needs, in int32 words, for a
// reference of L_r bytes and a normal of R_n rows of L_n (R_n 0: none) at
// k (C = 1: none).
long long region_kmers_scratch_words(int L_r, int R_n, int L_n, int k, int C) {
  if (L_r < k || (R_n && L_n < k) || R_n < 0 || !cluster_size(C)) return -1;
  return C * region_scratch(L_r - k + 1, R_n, R_n ? L_n - k + 1 : 0, C).stride;
}

// A CTA's dynamic shared memory for a sample of R_s rows of L_s bytes, a
// reference of L_r and a normal's rows of L_n (0: none) at k <= 15, in a
// cluster of C CTAs; -1 for sizes it does not take (a set shorter than k
// among them).
long long region_kmers_smem_bytes(long long R_s, int L_s, int L_r, int L_n, int k, int C) {
  if (k > MAX_K || L_s < k || L_r < k || (L_n && L_n < k) || R_s < 0 ||
      !cluster_size(C))
    return -1;
  return region_layout(R_s, L_s - k + 1, longest_row(L_s, L_r, L_n), C).bytes;
}

// The clusters of C CTAs at the opt-in shared memory that card `device`
// can run at once (cudaOccupancyMaxActiveClusters; C = 1: 1 where a block
// of it fits); -1 on an error, 0 for a size it cannot. The current card is
// left as it was.
int region_kmers_max_clusters(int C, int device) {
  int prev = 0;
  if (!cluster_size(C) || cudaGetDevice(&prev) != cudaSuccess) return -1;
  if (prev != device && cudaSetDevice(device) != cudaSuccess) return -1;
  const int bytes = smem_optin();
  int clusters = bytes > 0 ? 1 : -1;
  if (C > 1 && bytes > 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    if (cluster_config(&cfg, &attr, C, (size_t)bytes, nullptr) != cudaSuccess)
      clusters = -1;
    else if (cudaOccupancyMaxActiveClusters(&clusters, (const void*)region_kmers_kernel<true>,
                                            &cfg) != cudaSuccess)
      cudaGetLastError(), clusters = 0;
  }
  if (prev != device) cudaSetDevice(prev);
  return clusters;
}

// One launch of one cluster of C CTAs (C = 1: one block): sample [R_s,
// L_s] int8 codes and int32 lengths, the reference's L_r codes and its
// length (int32 [1]), the normal's [R_n, L_n] codes and lengths (n_codes
// null: none) -> out int32 [2 + 2 cap]: the kept runs, the runs, then
// (value, count) pairs ascending by value; scratch int32 [scratch_words]
// (region_kmers_scratch_words at least; 16-byte aligned; C = 1 none);
// clocks (null: none) int64 [C, 11] clock64 stamps of each CTA's phases.
// Code arrays 16-byte aligned,
// each readable to the end of its last 16-byte line. cudaErrorInvalidValue,
// with nothing launched, for sizes the layout does not take or that do
// not fit the card's opt-in shared memory.
int region_kmers_launch(const void* s_codes, const void* s_len, int R_s, int L_s,
                        const void* r_codes, const void* r_len, int L_r, const void* n_codes,
                        const void* n_len, int R_n, int L_n, int k, int min_count, void* out,
                        long long cap, void* scratch, long long scratch_words, int C,
                        void* clocks, void* stream) {
  const bool normal = n_codes != nullptr;
  const int ln = normal ? L_n : 0;
  const long long bytes = region_kmers_smem_bytes(R_s, L_s, L_r, ln, k, C);
  if (bytes < 0 || (normal && (R_n < 0 || L_n < k)) || !aligned16(s_codes) ||
      !aligned16(r_codes) || (normal && !aligned16(n_codes)) || cap < 0 || bytes > smem_optin())
    return (int)cudaErrorInvalidValue;
  const Layout l = region_layout(R_s, L_s - k + 1, longest_row(L_s, L_r, ln), C);
  const Scratch z = region_scratch(L_r - k + 1, normal ? R_n : 0, normal ? L_n - k + 1 : 0, C);
  if (l.rows * (L_s - k + 1) > MAX_KEYS || scratch_words < C * z.stride ||
      (z.stride && !aligned16(scratch)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.sample = {(const int8_t*)s_codes, (const int32_t*)s_len, R_s, L_s, 0};
  a.ref = {(const int8_t*)r_codes, (const int32_t*)r_len, 1, L_r, 0};
  a.normal = {(const int8_t*)n_codes, (const int32_t*)n_len, normal ? R_n : 0,
              normal ? L_n : k, 0};
  a.scratch = (int32_t*)scratch;
  a.z = z;
  a.k = k;
  a.min_count = min_count;
  a.out = (int32_t*)out;
  a.cap = cap;
  a.x_lines = l.x_lines;
  a.s_words = l.s_words;
  a.b_words = l.b_words;
  a.clocks = (long long*)clocks;
  if (C == 1) {
    region_kmers_kernel<false><<<1, THREADS, (size_t)bytes, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(&cfg, &attr, C, (size_t)bytes, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, region_kmers_kernel<true>, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
