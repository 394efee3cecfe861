// Inclusive running max along the lanes of an int32 [R, W] array
// (W <= 1024), for Hopper (sm_90a), in the register layout of
// csrc/sw_wavefront.cu: one warp a row, no shared memory, no barrier.
//
// Replaces the Pallas bodies of tools/probe_mosaic_cummax.py (k_cummax,
// lax.cummax, and k_accum, jnp.maximum.accumulate: the same function),
// which asked whether Mosaic lowers a lane-axis running max. The plain
// version is torch.cummax(x, 1).values
// (breakmer_tpu_torch/tools/probe_mosaic_cummax.py).
//
// Why it matters: if an SW kernel computes a whole row (or column) of
// the matrix at once instead of an anti-diagonal, the gap along that row
// makes each cell wait for the one before it. The prefix-scan form of
// that recurrence removes the chain: the gap term of cell i is
// max over k < i of (H'[k] + k*ge) - go - (i-1)*ge, a running max of
// H' + k*ge (H' the row's values before the gap term). A row-sweeping SW
// kernel in sw_wavefront.cu's layout would pay one such scan a row, in
// the form this kernel runs; this probe gives its cost.
//
// Layout. One warp a row, `warps` rows a block (1 to 8; the wrapper's
// plan picks it). Thread l holds the P consecutive lanes l*P .. l*P+P-1
// in registers, P = ceil(W / 32) rounded up to a power of two, a template
// constant in {1, 2, 4, 8, 16, 32} (breakmer_tpu_torch/tools/warp_layout.py
// is the same layout in Python). Lanes past W hold INT_MIN: in a prefix
// scan they feed only lanes above them, and they are never stored.
//
// The scan. Each thread runs an inclusive max over its P registers; the
// warp runs an inclusive scan of the 32 thread totals (five
// __shfl_up_sync and max steps); one more __shfl_up_sync by 1 gives each
// thread the max of the threads before it (thread 0: INT_MIN), and each
// thread takes the max of that carry and each of its P values. Every
// thread of a live warp reaches every shuffle: the loads and stores are
// guarded, the shuffles are not, and a warp whose row is past R exits
// as a whole before the first one.
//
// Loads and stores. Where every row and pointer is 16-byte aligned
// (W % 4 == 0, P >= 4), 16-byte vectors in a coalesced order: at its
// j-th access thread l takes the row's 16-byte chunk 32 j + rot(l) (rot
// a rotation of the lane's 5 bits), so each warp access covers 512
// contiguous bytes, and log2(P) - 2 butterfly stages of __shfl_xor_sync
// (each swaps one bit of the chunk index with one bit of the lane) bring
// the row into the layout; the same stages take it back before the
// stores. Loading the layout directly gives each thread a 4P-byte run,
// a whole 128-byte line at P = 32, so that every warp access touches 32
// lines; in that order the kernel took twice its present time at
// [16384, 1024] (PERF.md, section 6). Element by element in the
// layout's own order otherwise (a ragged W % 4 or an unaligned pointer).
//
// What bounds it on this card: bytes. Each element is read once and
// written once (8 bytes) for one max (the kernel issues about two); at
// [16384, 1024] or [65536, 256] that is 134.2 MB, 40.1 us at 3.35 TB/s,
// against 1.0 us for the maxes at the card's int32 rate. At the probe's
// [8, 256] the bound (16 KB, 0.005 us) is far under one launch, so the
// launch and the host's launch path set the time there. On an NVIDIA
// H100 80GB HBM3 at 700 W: 47.4-48.0 us on the device at both bandwidth
// shapes (84 % of the bound, about a device copy's rate), and one
// launch, 0.5-1.3 us by the profiler, at [8, 256] (PERF.md, section 6).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;  // rows a block

__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

// The 16-byte chunk of a row that thread `lane` loads (and stores) at its
// j-th access is 32 j + chunk_lane<P>(lane): lane rotated left by
// log2(P) - 2 bits within 5, so each access of the warp covers 512
// contiguous bytes.
template <int P>
__device__ __forceinline__ int chunk_lane(int lane) {
  constexpr int S = log2i(P) - 2;
  return ((lane << S) | (lane >> (5 - S))) & 31;
}

// From the coalesced order to the layout (and back: each stage is its own
// inverse, and the stages commute): stage b swaps bit b of the chunk
// index with lane bit 5 - S + b, one __shfl_xor_sync a register pair.
// After the S stages thread l holds lanes l*P .. l*P+P-1 in order.
template <int P>
__device__ __forceinline__ void exchange(int (&v)[P], int lane) {
  constexpr int S = log2i(P) - 2;
#pragma unroll
  for (int b = 0; b < S; ++b) {
    const int mask = 1 << (5 - S + b);
    const bool hi = lane & mask;  // keeps the chunks whose bit b is set
#pragma unroll
    for (int i = 0; i < P / 4; ++i) {
      if (i & (1 << b)) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int& r0 = v[4 * i + c];
        int& r1 = v[4 * (i | (1 << b)) + c];
        const int got = __shfl_xor_sync(FULL, hi ? r0 : r1, mask);
        if (hi) r0 = got;
        else r1 = got;
      }
    }
  }
}

// VEC: 16-byte loads and stores in the coalesced order, then exchange
// (P >= 4, W % 4 == 0, both pointers 16-byte aligned); else element by
// element in the layout's own order.
template <int P, bool VEC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
probe_cummax_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int R, int W) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= R) return;  // a whole warp: no shuffle waits on it
  const size_t base = (size_t)row * W;
  const int first = lane * P;
  const int n = min(max(W - first, 0), P);  // this thread's lanes below W
  int c0 = 0;  // the chunk of the first access, when VEC
  if constexpr (VEC) c0 = chunk_lane<P>(lane);

  int v[P];
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < P / 4; ++j) {
      const int c = 32 * j + c0;
      const int4 q = 4 * c < W ? __ldg((const int4*)(x + base) + c)
                               : make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
      v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z, v[4 * j + 3] = q.w;
    }
    exchange(v, lane);
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) v[k] = k < n ? __ldg(x + base + first + k) : INT_MIN;
  }

#pragma unroll
  for (int k = 1; k < P; ++k) v[k] = max(v[k], v[k - 1]);
  int t = v[P - 1];  // the thread's total, then the max of threads 0..lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, t, off);
    if (lane >= off) t = max(t, y);
  }
  int carry = __shfl_up_sync(FULL, t, 1);
  if (lane == 0) carry = INT_MIN;
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = max(v[k], carry);

  if constexpr (VEC) {
    exchange(v, lane);
#pragma unroll
    for (int j = 0; j < P / 4; ++j) {
      const int c = 32 * j + c0;
      if (4 * c < W)
        ((int4*)(out + base))[c] = make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < n) out[base + first + k] = v[k];
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int P>
cudaError_t launch(const void* x, void* out, int R, int W, int warps, cudaStream_t stream) {
  const dim3 grid((R + warps - 1) / warps), block(warps * 32);
  if (P >= 4 && W % 4 == 0 && aligned16(x) && aligned16(out))
    probe_cummax_kernel<P, P >= 4><<<grid, block, 0, stream>>>((const int32_t*)x,
                                                               (int32_t*)out, R, W);
  else
    probe_cummax_kernel<P, false><<<grid, block, 0, stream>>>((const int32_t*)x,
                                                              (int32_t*)out, R, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One warp a row, P lanes a thread, `warps` rows a block, on ``stream``;
// returns the cudaError_t of the launch. x and out are device pointers to
// [R, W] int32, R > 0, 1 <= W <= 32 P, P in {1, 2, 4, 8, 16, 32}
// (warp_layout.py picks it), 1 <= warps <= 8.
int probe_cummax_launch(const void* x, void* out, int R, int W, int P, int warps,
                        void* stream) {
  if (R <= 0 || W < 1 || W > 32 * P || warps < 1 || warps > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 1: return (int)launch<1>(x, out, R, W, warps, s);
    case 2: return (int)launch<2>(x, out, R, W, warps, s);
    case 4: return (int)launch<4>(x, out, R, W, warps, s);
    case 8: return (int)launch<8>(x, out, R, W, warps, s);
    case 16: return (int)launch<16>(x, out, R, W, warps, s);
    case 32: return (int)launch<32>(x, out, R, W, warps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
