// The SW wavefront loop stripped to its per-step exchange, for Hopper
// (sm_90a): a probe of what bounded the first design of
// csrc/sw_wavefront.cu (one block a pair, a barrier a diagonal). The
// "sw_wavefront" below is that design, since replaced by a
// warp-synchronous wavefront in registers.
//
// Replaces tools/sw_ceiling_probe.py::_loop_kernel (launched by
// stripped). Per row of B rows, four int32 state vectors of Lq lanes
// (hd1 = the query codes, hd2 = 0, fd1 = 0, tj = the first Lq target
// codes) go through `steps` steps of
//
//   rolls3: a = roll(hd2), b = roll(fd1), c = roll(tj)   (out[i] = x[i-1],
//           lane 0 takes lane Lq-1, as np.roll(x, 1, axis=1))
//   rolls0: a = max(hd2, 1), b = max(fd1, 2), c = max(tj, 3)
//   h = max(max(a, b), max(c, hd1)); hd2 = hd1; hd1 = h; fd1 = b; tj = c
//
// and the row's final hd1 is the output. The plain version is
// breakmer_tpu_torch/tools/sw_ceiling_probe.py::stripped_plain.
//
// Design, laid out to read against sw_wavefront.cu: one block per row;
// the threads stride over the Lq lanes; the state lives in shared memory
// in rotating buffers (H in three, as sw_wavefront's H diagonals; F and
// the target stream in two each), so each step reads the previous steps'
// buffers and writes a buffer nobody reads in that step, and one
// __syncthreads a step orders the sweep, as that design's did. In
// rolls3 a thread reads lane i-1, which another thread wrote: the
// cross-thread exchange that sw_wavefront makes on every diagonal
// (h1[i-1], f1[i-1], h2[i-1]). rolls0 keeps all of that exchange except
// the neighbour: the same shared-memory buffers, loads, stores and the
// barrier a step, with every thread reading its own lane. So
// rolls3 / full is the share of sw_wavefront's time that its
// per-diagonal exchange skeleton (shared-memory round trip + barrier)
// sets, and rolls3 - rolls0 is what reading a neighbour's lane costs
// over reading one's own.
//
// What bounds it on this card: nothing but the barrier and the shared
// memory latency of each step. The work a step is a few integer ops per
// lane; the inputs are read once and the output written once. Measured
// at 512 x 256 x 512 on an NVIDIA H100 80GB HBM3 at 700 W: rolls3 is
// about 0.6 of sw_wavefront's time, rolls0 about 2.5 % below rolls3.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool ROLLS>
__global__ void sw_ceiling_probe_kernel(const int8_t* __restrict__ q,
                                        const int8_t* __restrict__ t,
                                        int Lq, int Lt, int steps,
                                        int32_t* __restrict__ out) {
  extern __shared__ int smem[];
  // H(s % 3) at 0..2, F(s & 1) at 3..4, T(s & 1) at 5..6, each Lq long
  int* H = smem;
  int* F = smem + 3 * Lq;
  int* Tj = smem + 5 * Lq;
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int8_t* qb = q + (size_t)b * Lq;
  const int8_t* tb = t + (size_t)b * Lt;

  // step s reads H(s-1) at (s+2)%3, H(s-2) at (s+1)%3, F(s-1) and T(s-1)
  // at (s+1)&1; so H(-1) = q goes in buffer 2, H(-2), F(-1), T(-1) in 1
  for (int i = tid; i < Lq; i += T) {
    H[2 * Lq + i] = qb[i];
    H[Lq + i] = 0;
    F[Lq + i] = 0;
    Tj[Lq + i] = tb[i];
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    int* hc = H + (s % 3) * Lq;
    const int* h1 = H + ((s + 2) % 3) * Lq;
    const int* h2 = H + ((s + 1) % 3) * Lq;
    int* fc = F + (s & 1) * Lq;
    const int* f1 = F + ((s + 1) & 1) * Lq;
    int* tc = Tj + (s & 1) * Lq;
    const int* t1 = Tj + ((s + 1) & 1) * Lq;
    for (int i = tid; i < Lq; i += T) {
      int a, bb, c;
      if (ROLLS) {
        const int n = i == 0 ? Lq - 1 : i - 1;
        a = h2[n];
        bb = f1[n];
        c = t1[n];
      } else {
        a = max(h2[i], 1);
        bb = max(f1[i], 2);
        c = max(t1[i], 3);
      }
      hc[i] = max(max(a, bb), max(c, h1[i]));
      fc[i] = bb;
      tc[i] = c;
    }
    __syncthreads();
  }

  const int* last = H + ((steps + 2) % 3) * Lq;  // H(steps - 1)
  for (int i = tid; i < Lq; i += T) out[(size_t)b * Lq + i] = last[i];
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch needs: 7 int32 vectors of Lq.
long long sw_ceiling_probe_smem_bytes(int Lq) { return 7LL * Lq * 4; }

// One block per row on ``stream``; returns the cudaError_t of the launch.
// q [B, Lq] and t [B, Lt] int8 (Lt >= Lq), out [B, Lq] int32, all device
// pointers.
int sw_ceiling_probe_launch(const void* q, const void* t, int B, int Lq,
                            int Lt, int steps, int rolls, int threads,
                            void* out, void* stream) {
  const long long smem = sw_ceiling_probe_smem_bytes(Lq);
  auto kern = rolls ? sw_ceiling_probe_kernel<true>
                    : sw_ceiling_probe_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const int8_t*)t, Lq, Lt, steps, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
