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
// [G, N] (the batched step's form) and works row by row.
//
// What bounds them on this card: bytes, and at the serial path's shapes
// the launch. Each does a handful of integer operations a byte it moves
// (no tensor core applies), so its bound is its bytes (each input read
// once, each output written once) over 3.35 TB/s: kmer_codes at the batch
// step's shape (16,384 reads of 128 bases, k = 15) reads 2.1 MB and
// writes 16.8 MB, 5.6 us. A region of the serial path (about 200 reads of
// 100 bases) moves under 200 KB, well under a microsecond, so there a
// kernel's time is one launch; the eager plain version paid dozens.
//
// Design. One thread an output element, 256 threads a block, consecutive
// threads on consecutive elements, so every load and store of a warp is
// coalesced (the 8-byte codes and the 1-byte flags of 32 elements are
// each one contiguous run):
// - kmer_codes: thread (r, w) reads its window's k codes (bytes that the
//   warp's neighbouring windows share, served by L1) and shift-ors them.
// - revcomp_kmers: k two-bit steps on one element in registers.
// - unique_counts: a thread whose element starts a run counts it as
//   upper_bound(row, v) - i, found by a galloping search from i (probes
//   at i + 1, i + 2, i + 4, ... then a binary search in the last gap):
//   log2 of the run's length in loads, so a poly-A region's single k-mer
//   of R * W copies costs about 20 loads, not R * W. That is the JAX
//   function's min(next run start, total valid): the first index past a
//   run is the next distinct code or the first SENTINEL.
// - subtract_sorted: a thread whose value is not SENTINEL runs a
//   lower-bound binary search in its row of the reference table and, if
//   it is not found there, of the normal table (a table's row stays in L2
//   while its row's threads search it). SENTINEL slots, most of a count
//   row's slots, load nothing more.
// No shared memory, no barrier. A kernel never writes where it reads, so
// the outputs are fresh tensors.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6; device time
// of queued calls): at a serial region's shapes each kernel is one launch,
// 2.3-7.7 us, where the plain versions take 66-1,059 us; at the batch
// step's shapes kmer_codes 29.1-29.4 us (bound 5.7), revcomp_kmers 3.0-3.2
// (bound 0.6), unique_counts 14.2-22.8 (bound 11.7, the more and longer
// runs of tiled reads the slower) and subtract_sorted 83.4-84.3 (bound
// 16.2). Dividing the element index in 32 bits and unrolling the window
// loop moved none of these by more than 3 %, so neither was kept. What
// holds kmer_codes and subtract_sorted above their bounds is not measured
// (no hardware-counter profile was taken); one DRAM round trip a thread
// with few loads in flight, and the searches' chains of dependent loads,
// are the candidates for a later design.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t SENT = 0xFFFFFFFFLL;
constexpr int THREADS = 256;
constexpr int MAX_K = 15;

__device__ __forceinline__ int64_t element() {
  return (int64_t)blockIdx.x * THREADS + threadIdx.x;
}

// kmers, valid [R, W], W = L - k + 1. A code >= 4 (N, pad, or any other
// byte >= 4) invalidates its windows; a negative byte shift-ors in
// sign-extended, as the plain version's int64 cast does.
__global__ void __launch_bounds__(THREADS)
kmer_codes_kernel(const int8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                  int64_t R, int L, int k, int64_t* __restrict__ kmers,
                  uint8_t* __restrict__ valid) {
  const int W = L - k + 1;
  const int64_t e = element();
  if (e >= R * W) return;
  const int64_t r = e / W;
  const int w = (int)(e - r * W);
  const int8_t* c = codes + r * L + w;
  uint64_t acc = 0;
  bool bad = false;
  for (int j = 0; j < k; ++j) {
    const int8_t x = c[j];
    bad |= x >= 4;
    acc = (acc << 2) | (x >= 4 ? 0 : (uint64_t)(int64_t)x);
  }
  // w <= length - k in wrapping int32, as the plain version computes it
  const int last = (int)((uint32_t)lengths[r] - (uint32_t)k);
  const bool ok = w <= last && !bad;
  kmers[e] = ok ? (int64_t)acc : SENT;
  valid[e] = ok;
}

// out = the reverse complement over k bases; SENTINEL stays SENTINEL.
// The input's two-bit groups leave by an arithmetic shift, as torch's >>.
__global__ void __launch_bounds__(THREADS)
revcomp_kmers_kernel(const int64_t* __restrict__ x, int64_t n, int k,
                     int64_t* __restrict__ out) {
  const int64_t e = element();
  if (e >= n) return;
  const int64_t v = x[e];
  int64_t c = v;
  uint64_t o = 0;
  for (int j = 0; j < k; ++j) {
    o = (o << 2) | (uint64_t)(3 - (c & 3));
    c >>= 2;
  }
  out[e] = v == SENT ? SENT : (int64_t)o;
}

// rows [rows, n], each sorted. At a run start i (a value that is not
// SENTINEL and differs from the one before it): values = row[i], counts =
// the run's length, is_start; elsewhere SENTINEL, 0, false.
__global__ void __launch_bounds__(THREADS)
unique_counts_kernel(const int64_t* __restrict__ s, int64_t rows, int64_t n,
                     int64_t* __restrict__ values, int32_t* __restrict__ counts,
                     uint8_t* __restrict__ is_start) {
  const int64_t e = element();
  if (e >= rows * n) return;
  const int64_t i = e % n;
  const int64_t* row = s + (e - i);
  const int64_t v = row[i];
  const bool start = v != SENT && (i == 0 || row[i - 1] != v);
  int32_t count = 0;
  if (start) {
    // row[lo] == v; hi == n or row[hi] != v (the row is sorted, so every
    // index past i holding v lies below the first that does not)
    int64_t lo = i, hi = i + 1;
    for (int64_t step = 2; hi < n && row[hi] == v; step <<= 1) {
      lo = hi;
      hi = i + step;
    }
    hi = hi < n ? hi : n;
    while (hi - lo > 1) {
      const int64_t mid = lo + (hi - lo) / 2;
      if (row[mid] == v) lo = mid;
      else hi = mid;
    }
    count = (int32_t)(hi - i);
  }
  values[e] = start ? v : SENT;
  counts[e] = count;
  is_start[e] = start;
}

// v in the sorted table t[0 .. m)? The lower bound, then one compare (a
// table of width 0 finds nothing).
__device__ __forceinline__ bool member(const int64_t* __restrict__ t, int64_t m, int64_t v) {
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (t[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo < m && t[lo] == v;
}

// Sample slots [rows, n] against the reference table [rows, m_ref] and,
// when normal is not null, the normal table [rows, m_normal], row g
// against row g: a slot is kept iff its value is not SENTINEL and lies in
// neither table; kept slots keep (value, count), the others become
// (SENTINEL, 0).
__global__ void __launch_bounds__(THREADS)
subtract_sorted_kernel(const int64_t* __restrict__ values, const int32_t* __restrict__ counts,
                       const int64_t* __restrict__ ref, int64_t m_ref,
                       const int64_t* __restrict__ normal, int64_t m_normal,
                       int64_t rows, int64_t n, int64_t* __restrict__ out_values,
                       int32_t* __restrict__ out_counts) {
  const int64_t e = element();
  if (e >= rows * n) return;
  const int64_t g = e / n;
  const int64_t v = values[e];
  const bool keep = v != SENT && !member(ref + g * m_ref, m_ref, v) &&
                    !(normal != nullptr && member(normal + g * m_normal, m_normal, v));
  out_values[e] = keep ? v : SENT;
  out_counts[e] = keep ? counts[e] : 0;
}

bool grid(int64_t elements, unsigned* blocks) {
  const int64_t b = (elements + THREADS - 1) / THREADS;
  if (elements <= 0 || b > INT_MAX) return false;
  *blocks = (unsigned)b;
  return true;
}

}  // namespace

// Each entry point launches one kernel on ``stream`` and returns the
// cudaError_t of the launch (cudaErrorInvalidValue, with nothing launched,
// for arguments it does not take, a grid of 0 blocks among them). Pointers
// are to contiguous device memory; int64 codes, int32 counts and lengths,
// int8 base codes, one byte a bool.
extern "C" {

// codes [R, L], lengths [R] -> kmers, valid [R, L - k + 1]; 1 <= k <= 15.
int kmer_codes_launch(const void* codes, const void* lengths, long long R, int L, int k,
                      void* kmers, void* valid, void* stream) {
  unsigned blocks;
  if (k < 1 || k > MAX_K || L < k || !grid(R * (L - k + 1), &blocks))
    return (int)cudaErrorInvalidValue;
  kmer_codes_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const int32_t*)lengths, R, L, k, (int64_t*)kmers,
      (uint8_t*)valid);
  return (int)cudaGetLastError();
}

// x [n] -> out [n]; 1 <= k <= 15.
int revcomp_kmers_launch(const void* x, long long n, int k, void* out, void* stream) {
  unsigned blocks;
  if (k < 1 || k > MAX_K || !grid(n, &blocks)) return (int)cudaErrorInvalidValue;
  revcomp_kmers_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)x, n, k, (int64_t*)out);
  return (int)cudaGetLastError();
}

// s [rows, n] -> values, counts, is_start [rows, n]; n < 2^31.
int unique_counts_sorted_launch(const void* s, long long rows, long long n, void* values,
                                void* counts, void* is_start, void* stream) {
  unsigned blocks;
  if (n < 1 || n > INT_MAX || !grid(rows * n, &blocks)) return (int)cudaErrorInvalidValue;
  unique_counts_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)s, rows, n, (int64_t*)values, (int32_t*)counts, (uint8_t*)is_start);
  return (int)cudaGetLastError();
}

// values, counts [rows, n], ref [rows, m_ref], normal [rows, m_normal] or
// null -> out_values, out_counts [rows, n]; m_ref, m_normal >= 0.
int subtract_sorted_launch(const void* values, const void* counts, const void* ref,
                           long long m_ref, const void* normal, long long m_normal,
                           long long rows, long long n, void* out_values, void* out_counts,
                           void* stream) {
  unsigned blocks;
  if (n < 1 || m_ref < 0 || m_normal < 0 || !grid(rows * n, &blocks))
    return (int)cudaErrorInvalidValue;
  subtract_sorted_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)values, (const int32_t*)counts, (const int64_t*)ref, m_ref,
      (const int64_t*)normal, m_normal, rows, n, (int64_t*)out_values, (int32_t*)out_counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
