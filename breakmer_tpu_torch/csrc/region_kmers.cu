// A serial region's k-mer call, sample_only_kmers, as one kernel of one
// block for Hopper (sm_90a): the sample's k-mer codes, their distinct
// values and counts, less every value of the reference (both strands) and
// of the matched normal, kept where the count reaches min_count.
//
// Replaces no Pallas kernel: it replaces the host composite
// breakmer_tpu/ops/kmer.py:190-235 (sample_only_kmers), which chains the
// jitted kmer_codes (three times), sort_kmers, unique_counts_sorted, the
// reference's both-strand table and its sort, and subtract_sorted, one XLA
// program each. The port ran that chain as K1-K4 of csrc/kmer.cu and three
// torch.sort calls: 30 CUDA kernels and 33 copies a call, each kernel one
// launch's floor at a serial region's size. The plain version is
// breakmer_tpu_torch/ops/kmer.py::sample_only_kmers_plain (the chain of the
// plain functions); the wrapper is ops/kmer_cuda.py::region_kmers, and
// ops/kmer.py routes a region here when kmer_cuda.region_plan says it fits.
//
// What bounds it: one block on one SM, so neither bytes (a region's ~40 KB
// in and a few KB out) nor the card's operations; the block's own passes
// over shared memory and their barriers. On an NVIDIA H100 80GB HBM3 at
// 700.00 W (tools/kmer_time.py; PERF.md, section 6): 84.7-84.9 us at 200
// reads of 100 bases with a reference of 1,800 and a normal of 160 reads,
// 62 % of it the sort, 32 % the three sets' codes (clock64 stamps); the
// 30 kernels it replaces took 0.22 ms of device time there, the 101
// regions of the serial 100-gene panel take 3.7 ms.
//
// Design. The host packs every input into one pinned buffer (one copy to
// the card) and reads one result buffer back (one copy): the kept runs,
// the runs, then (value, count) pairs. One block of 1,024 threads holds,
// in dynamic shared memory (the layout is region_layout below, mirrored by
// kmer_cuda.region_smem_bytes):
//   X  a stage and scratch of x_lines 16-byte lines (at least the
//      sample's windows + 1 words, and a row's bytes);
//   S  the sample's valid codes, n_s words at most;
//   B  a bit a slot of S (the slot's value lies in the reference or the
//      normal);
//   O  32 x 256 uint16 digit offsets, a warp's row each (the sort);
//   M  a few words for scans and counters.
// 1. Codes. A set's rows are staged in X, as many whole rows at a time as
//    fit, with 16-byte loads; each thread then takes consecutive windows
//    of one staged row (1,024 / rows threads a row, or, past 1,024 rows,
//    whole rows): k steps at its first window, all threads at once, then
//    one shift, or and mask a window (the rolling code of csrc/kmer.cu's
//    kmer_codes_kernel, with its direct uint32 code for a window that
//    holds a negative byte). A sample window that is valid and not
//    SENTINEL is appended to S, a warp's appends placed by one shared
//    atomic.
// 2. Sort. S is sorted by an LSD radix sort of 2 or 4 passes of at most 8
//    bits (the bits of the OR of S's values; an even number of passes, so
//    the keys end in S), X the other buffer. Warp w owns the w-th 32nd of
//    the keys; a pass counts each warp's digits (shared atomic adds on its
//    row of O, two uint16 counts a word), scans the counts digit-major
//    over the 32 warps, then scatters its keys 32 at a time in order: a
//    key goes to its warp's offset of its digit plus its rank among the
//    lanes before it with that digit (the lanes of a digit found by one
//    match instruction). Stable, so the passes sort.
// 3. Membership. O, free after the sort, takes an index of S: the first
//    slot of each of 4,096 buckets of the keys' top 12 bits. The
//    reference's rows, then the normal's, are staged in X in turn and
//    their codes computed as in 1; each valid code (and, for the
//    reference, its reverse complement) is searched in its bucket of S
//    (a few slots at a serial region's size) by a branchless binary
//    search and, where found, sets the bit of its first slot in B. Neither
//    table is stored or sorted.
// 4. Runs. A slot starts a run where its value differs from the one
//    before; each thread counts the starts of its consecutive slots, a
//    block scan places them, and X takes the start positions (and n at
//    the end): run u is [X[u], X[u + 1]).
// 5. Output. Each thread takes consecutive runs, keeps a run whose count
//    is at least min_count and whose start's bit is clear, and a block
//    scan places the kept (value, count) pairs, ascending by value.
// The sort and the offsets need n_s < 65,536; ops/kmer.py takes the
// per-function route (K1-K4 and torch.sort) for a region whose layout
// does not fit the block's opt-in shared memory (227 KB on an H100), and
// the launch refuses one.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;        // digits of at most 8 bits
constexpr int MISC_WORDS = 64;   // M: 32 warp sums, then the counters below
constexpr int MAX_KEYS = 65535;  // S's slots: the uint16 offsets of O
constexpr int BUCKETS = 4096;    // the search index over S's top 12 bits, in O after the sort
constexpr int MAX_K = 15;
constexpr uint32_t SENT = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
// M's counters past the 32 warp sums
constexpr int M_KEYS = 32;  // S's appended values
constexpr int M_OR = 33;    // the OR of S's values

// The dynamic shared memory of a region: X's 16-byte lines, S's and B's
// words and the total in bytes (O and M at the end). n_s: the sample's
// windows; longest: the longest row of the three sets, in bytes.
struct Layout {
  long long x_lines, s_words, b_words, bytes;
};

__host__ __device__ inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
__host__ __device__ inline long long round4(long long a) { return (a + 3) / 4 * 4; }

__host__ __device__ inline Layout region_layout(long long n_s, long long longest) {
  Layout l;
  const long long keys = ceil_div(n_s + 1, 4), row = ceil_div(longest + 30, 16);
  l.x_lines = keys > row ? keys : row;
  l.s_words = round4(n_s);
  l.b_words = round4(ceil_div(n_s, 32));
  l.bytes = 16 * l.x_lines + 4 * (l.s_words + l.b_words) + 2 * WARPS * BINS + 4 * MISC_WORDS;
  return l;
}

struct Set {
  const int8_t* codes;     // [R, L], 16-byte aligned
  const int32_t* lengths;  // [R]
  int R, L;
};

struct Args {
  Set sample, ref, normal;  // normal.codes null: no normal
  int k, min_count;
  int32_t* out;  // [2 + 2 cap]: kept pairs, runs, then (value, count) pairs
  long long cap;
  long long x_lines, s_words, b_words;
};

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
// never SENTINEL here).
__device__ __forceinline__ uint32_t revcomp(uint32_t v, int k) {
  constexpr uint64_t ODD = 0x5555555555555555ull;
  uint64_t y = __brevll((unsigned long long)v);
  y = ((y >> 1) & ODD) | ((y & ODD) << 1);
  return (uint32_t)(~y >> (64 - 2 * k));
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

// The lanes of the warp that hold `in` and the same digit d as this lane
// (one match instruction; a lane without `in` matches none).
__device__ __forceinline__ unsigned peers(uint32_t d, bool in) {
  return __match_any_sync(FULL, in ? d : 0x100u + (threadIdx.x & 31));
}

// Sorts keys[0 .. n) ascending by their low `bits` bits (every key has no
// other bit set), tmp[0 .. n) the other buffer; the keys end in keys.
__device__ void radix_sort(uint32_t* keys, uint32_t* tmp, int n, int bits, uint16_t* offs,
                           int* warp_sums) {
  if (bits == 0 || n <= 1) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int passes = bits <= 16 ? 2 : 4;
  const int width = (bits + passes - 1) / passes;
  const uint32_t dmask = (1u << width) - 1;
  const int seg = (int)((ceil_div(n, WARPS) + 31) / 32 * 32);  // whole 32-key chunks a warp
  const int a = min(n, warp * seg), b = min(n, a + seg);
  uint16_t* mine = offs + warp * BINS;
  uint32_t* src = keys;
  uint32_t* dst = tmp;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * width;
    for (int i = threadIdx.x; i < WARPS * BINS / 2; i += THREADS)
      reinterpret_cast<uint32_t*>(offs)[i] = 0;
    __syncthreads();
    // the warp's count of each digit: shared atomic adds to the uint16
    // halves of its row's words (a count stays below 65,536)
    for (int i = a + lane; i < b; i += 32) {
      const uint32_t d = (src[i] >> shift) & dmask;
      atomicAdd(reinterpret_cast<unsigned*>(mine + (d & ~1u)), 1u << (16 * (d & 1)));
    }
    __syncthreads();
    {  // digit-major exclusive scan: thread t holds digit t / 4 of warps 8 (t % 4) .. + 7
      const int d = threadIdx.x >> 2, w0 = (threadIdx.x & 3) * 8;
      int c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += c[j] = offs[(w0 + j) * BINS + d];
      int total;
      int at = block_scan(s, warp_sums, &total);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        offs[(w0 + j) * BINS + d] = (uint16_t)at;
        at += c[j];
      }
    }
    __syncthreads();
    for (int c = a; c < b; c += 32) {  // the stable scatter
      const int i = c + lane;
      const bool in = i < b;
      const uint32_t key = in ? src[i] : 0;
      const uint32_t d = (key >> shift) & dmask;
      const unsigned same = peers(d, in);
      const int base = in ? mine[d] : 0;
      __syncwarp();
      if (in) {
        const unsigned before = same & lanes_below();
        dst[base + __popc(before)] = key;
        if (before == 0) mine[d] = (uint16_t)(base + __popc(same));
      }
      __syncwarp();
    }
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
}

// Sets the bit of v's first slot in sorted s, if v is there: a
// branchless binary search of v's bucket [start[v >> shift], start[(v >>
// shift) + 1]) (a value past the last bucket is past every slot).
__device__ __forceinline__ void mark(const uint32_t* s, const uint16_t* start, int shift,
                                     uint32_t* bits, uint32_t v) {
  const uint32_t b = v >> shift;
  if (b >= BUCKETS) return;
  int at = start[b];
  const int end = start[b + 1];
  if (at == end) return;
  for (int len = end - at; len > 1; len -= len >> 1) {
    const int half = len >> 1;
    at = s[at + half] < v ? at + half : at;
  }
  at += s[at] < v;
  if (at < end && s[at] == v) atomicOr(&bits[at >> 5], 1u << (at & 31));
}

enum Mode { APPEND, MARK_BOTH, MARK };

// Every window of a set, in chunks of whole rows staged in X: APPEND adds
// the sample's valid codes that are not SENTINEL to S (m[M_KEYS] of them;
// m[M_OR] their OR); MARK_BOTH marks each valid code of the reference and
// its reverse complement in B, MARK each valid code of the normal. Every
// thread calls it; the windows a thread computes are consecutive.
template <Mode MODE>
__device__ void each_window(const Set& set, int k, uint4* stage, long long stage_lines,
                            uint32_t* s, int n, const uint16_t* start, int shift, uint32_t* bits,
                            int* m) {
  const int R = set.R, L = set.L, W = L - k + 1;
  if (R == 0 || (MODE != APPEND && n == 0)) return;
  const int lane = threadIdx.x & 31;
  const uint32_t mask = (1u << (2 * k)) - 1;  // k <= 15
  const int rows_per = (int)((16 * stage_lines - 30) / L);  // >= 1 by the layout
  uint32_t orv = 0;
  for (int r0 = 0; r0 < R; r0 += rows_per) {
    const int r1 = min(R, r0 + rows_per);
    const uintptr_t lo = (uintptr_t)(set.codes + (long long)r0 * L);
    const uintptr_t hi = (uintptr_t)(set.codes + (long long)r1 * L);
    const uintptr_t base = lo & ~(uintptr_t)15;
    const int lines = (int)((hi - base + 15) / 16);
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
      const int last = w0 < w1 ? (int)((uint32_t)set.lengths[r0 + r] - (uint32_t)k) : 0;
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
          if (i) {  // roll the window's last byte in
            const int8_t x = row[w + k - 1];
            if (x >= 4) bad_at = w + k - 1;
            if (x < 0) neg_at = w + k - 1;
            acc = ((acc << 2) | (uint32_t)(x & 3)) & mask;
          }
          if (w <= last && bad_at < w) code = neg_at >= w ? window_code(row + w, k) : acc;
        }
        const bool keep = in && code != SENT;
        if constexpr (MODE == APPEND) {  // a warp's appends placed by one atomic
          const unsigned b = __ballot_sync(FULL, keep);
          int at = 0;
          if (lane == 0 && b) at = atomicAdd(&m[M_KEYS], __popc(b));
          at = __shfl_sync(FULL, at, 0);
          if (keep) {
            s[at + __popc(b & lanes_below())] = code;
            orv |= code;
          }
        } else if (keep) {
          mark(s, start, shift, bits, code);
          if (MODE == MARK_BOTH) mark(s, start, shift, bits, revcomp(code, k));
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

__global__ void __launch_bounds__(THREADS) region_kmers_kernel(const Args args) {
  extern __shared__ uint4 smem[];
  uint4* stage = smem;
  uint32_t* x = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s = x + 4 * args.x_lines;
  uint32_t* bits = s + args.s_words;
  uint16_t* offs = reinterpret_cast<uint16_t*>(bits + args.b_words);
  int* m = reinterpret_cast<int*>(offs + WARPS * BINS);
  const int t = threadIdx.x;

  for (long long i = t; i < args.b_words; i += THREADS) bits[i] = 0;
  if (t < MISC_WORDS) m[t] = 0;
  __syncthreads();

  // 1-2: the sample's valid codes in S, sorted
  each_window<APPEND>(args.sample, args.k, stage, args.x_lines, s, 0, nullptr, 0, bits, m);
  const int n = m[M_KEYS];
  const uint32_t orv = (uint32_t)m[M_OR];
  const int key_bits = orv ? 32 - __clz(orv) : 0;
  radix_sort(s, x, n, key_bits, offs, m);

  // the search index in O: start[b], the first slot whose top 12 bits are
  // >= b; start[BUCKETS] = n
  uint16_t* start = offs;
  const int shift = key_bits > 12 ? key_bits - 12 : 0;
  {
    const int per = (n + THREADS - 1) / THREADS;
    const int a = min(n, t * per), b = min(n, a + per);
    for (int i = a; i < b; ++i) {
      const int hi = (int)(s[i] >> shift);
      for (int q = i ? (int)(s[i - 1] >> shift) + 1 : 0; q <= hi; ++q) start[q] = (uint16_t)i;
    }
    for (int q = (n ? (int)(s[n - 1] >> shift) + 1 : 0) + t; q <= BUCKETS; q += THREADS)
      start[q] = (uint16_t)n;
    __syncthreads();
  }

  // 3: the reference's codes and reverse complements, then the normal's
  each_window<MARK_BOTH>(args.ref, args.k, stage, args.x_lines, s, n, start, shift, bits, m);
  if (args.normal.codes != nullptr)
    each_window<MARK>(args.normal, args.k, stage, args.x_lines, s, n, start, shift, bits, m);

  // 4: run starts into X
  int runs;
  {
    const int per = (n + THREADS - 1) / THREADS;
    const int a = min(n, t * per), b = min(n, a + per);
    int c = 0;
    for (int i = a; i < b; ++i) c += i == 0 || s[i] != s[i - 1];
    int at = block_scan(c, m, &runs);
    for (int i = a; i < b; ++i)
      if (i == 0 || s[i] != s[i - 1]) x[at++] = (uint32_t)i;
    if (t == 0) x[runs] = (uint32_t)n;
    __syncthreads();
  }

  // 5: the kept runs, ascending
  {
    const int per = (runs + THREADS - 1) / THREADS;
    const int a = min(runs, t * per), b = min(runs, a + per);
    int c = 0;
    for (int u = a; u < b; ++u) {
      const uint32_t i = x[u];
      c += (int)(x[u + 1] - i) >= args.min_count && !((bits[i >> 5] >> (i & 31)) & 1);
    }
    int kept;
    long long at = block_scan(c, m, &kept);
    int2* pairs = reinterpret_cast<int2*>(args.out + 2);
    for (int u = a; u < b; ++u) {
      const uint32_t i = x[u];
      const int count = (int)(x[u + 1] - i);
      if (count >= args.min_count && !((bits[i >> 5] >> (i & 31)) & 1) && at < args.cap)
        pairs[at++] = make_int2((int)s[i], count);
    }
    if (t == 0) args.out[0] = kept, args.out[1] = runs;
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// The opt-in shared memory of a block on the current card, and the kernel
// let take it there (once a card).
int smem_optin() {
  static int limit[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (limit[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (v > 0 && cudaFuncSetAttribute(region_kmers_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      v) == cudaSuccess)
      limit[dev] = v;
  }
  return limit[dev];
}

}  // namespace

extern "C" {

// The kernel's dynamic shared memory for a sample of R_s rows of L_s
// bytes, a reference of L_r and a normal's rows of L_n (0: none) at k; -1
// for sizes it does not take.
long long region_kmers_smem_bytes(long long R_s, int L_s, int L_r, int L_n, int k) {
  if (k < 1 || k > MAX_K || L_s < k || L_r < k || (L_n && L_n < k) || R_s < 0) return -1;
  const long long longest = L_s > L_r ? (L_s > L_n ? L_s : L_n) : (L_r > L_n ? L_r : L_n);
  return region_layout(R_s * (L_s - k + 1), longest).bytes;
}

// One launch of one block: sample [R_s, L_s] int8 codes and int32 lengths,
// the reference's L_r codes and its length (int32 [1]), the normal's [R_n,
// L_n] codes and lengths (n_codes null: none) -> out int32 [2 + 2 cap]: the
// kept runs, the runs, then (value, count) pairs ascending by value. Code
// arrays 16-byte aligned, each readable to the end of its last 16-byte
// line. cudaErrorInvalidValue, with nothing launched, for sizes the layout
// does not take or that do not fit the card's opt-in shared memory.
int region_kmers_launch(const void* s_codes, const void* s_len, int R_s, int L_s,
                        const void* r_codes, const void* r_len, int L_r, const void* n_codes,
                        const void* n_len, int R_n, int L_n, int k, int min_count, void* out,
                        long long cap, void* stream) {
  const bool normal = n_codes != nullptr;
  const int ln = normal ? L_n : 0;
  const long long bytes = region_kmers_smem_bytes(R_s, L_s, L_r, ln, k);
  const long long n_s = (long long)R_s * (L_s - k + 1);
  if (bytes < 0 || n_s > MAX_KEYS || (normal && (R_n < 0 || L_n < k)) || !aligned16(s_codes) ||
      !aligned16(r_codes) || (normal && !aligned16(n_codes)) || cap < 0 ||
      bytes > smem_optin())
    return (int)cudaErrorInvalidValue;
  const Layout l = region_layout(n_s, L_s > L_r ? (L_s > ln ? L_s : ln) : (L_r > ln ? L_r : ln));
  Args a;
  a.sample = {(const int8_t*)s_codes, (const int32_t*)s_len, R_s, L_s};
  a.ref = {(const int8_t*)r_codes, (const int32_t*)r_len, 1, L_r};
  a.normal = {(const int8_t*)n_codes, (const int32_t*)n_len, normal ? R_n : 0,
              normal ? L_n : k};
  a.k = k;
  a.min_count = min_count;
  a.out = (int32_t*)out;
  a.cap = cap;
  a.x_lines = l.x_lines;
  a.s_words = l.s_words;
  a.b_words = l.b_words;
  region_kmers_kernel<<<1, THREADS, (size_t)bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
