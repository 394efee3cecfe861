// Inclusive running max along the lanes of an int32 [R, W] array, for
// Hopper (sm_90a).
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
// H' + k*ge (H' the row's values before the gap term). A later redesign
// of sw_wavefront.cu that sweeps rows instead of anti-diagonals would
// pay one such scan a row; this probe gives its cost.
//
// Design: one block per row, one thread per lane. Each warp scans its 32
// lanes with __shfl_up_sync (five steps); lane 31 of each warp writes the
// warp's max to shared memory; warp 0 scans those (at most 32) and each
// warp adds the carry of the warps before it. Two __syncthreads a row.
//
// What bounds it on this card: the launch. At [8, 256] it is 8 blocks of
// 256 threads, one load and one store a lane: 1.3 us of device time
// against 3.1-3.2 us for torch.cummax (NVIDIA H100 80GB HBM3, 700 W).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void probe_cummax_kernel(const int32_t* __restrict__ x, int W,
                                    int32_t* __restrict__ out) {
  __shared__ int carry[32];
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const size_t at = (size_t)blockIdx.x * W + i;
  int v = i < W ? x[at] : INT_MIN;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = max(v, y);
  }
  if (lane == 31) carry[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int c = lane < n_warps ? carry[lane] : INT_MIN;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, c, off);
      if (lane >= off) c = max(c, y);
    }
    if (lane < n_warps) carry[lane] = c;  // max over warps 0..lane
  }
  __syncthreads();
  if (warp > 0) v = max(v, carry[warp - 1]);
  if (i < W) out[at] = v;
}

}  // namespace

extern "C" {

// One block per row, blockDim = W rounded up to a multiple of 32
// (W <= 1024), on ``stream``; returns the cudaError_t of the launch.
// x and out are device pointers to [R, W] int32.
int probe_cummax_launch(const void* x, void* out, int R, int W, void* stream) {
  const int threads = (W + 31) / 32 * 32;
  probe_cummax_kernel<<<R, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, W, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
