// The SW wavefront loop stripped to its per-step exchange, for Hopper
// (sm_90a), laid out as the current csrc/sw_wavefront.cu: one warp a
// row, the state in registers, three warp shuffles a step, no shared
// memory and no barrier.
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
// Design, the skeleton of sw_wavefront.cu's: one warp a row, 4 warps a
// block (one warp an SM partition at the probe's 512 rows, as the SW
// kernel's plan has it at 512 x 256 x 512). Thread l holds the R
// consecutive lanes l*R .. l*R+R-1 of each of the four vectors in
// registers, R = ceil(Lq / 32) rounded up to a power of two, a template
// constant in {1, 2, 4, 8, 16} (R = 8 at Lq = 256, the SW plan's R at
// that shape; breakmer_tpu_torch/tools/warp_layout.py is the same
// layout in Python). A roll is an in-thread shift plus one __shfl_sync
// that brings lane i-1 from the thread before; thread 0 takes lane Lq-1
// from the thread that holds it (a lane past Lq never feeds it). So
// rolls3 passes three values a step down the warp, the three that
// sw_wavefront.cu passes with __shfl_up_sync (H, F and the target code),
// and rolls3 / full is the share of the SW kernel's time that its
// per-step exchange and a max a lane set. rolls0 keeps the registers and
// the loop and replaces the rolls with the three maxes, no shuffle:
// rolls3 - rolls0 is what the shuffles cost. The step loop is unrolled
// by R, so the in-thread shift is register renaming, not moves. q and t
// are read once and hd1 written once.
//
// What bounds it on this card: the integer pipe. h, a max of four
// values, is two max instructions a lane a step, since Hopper's VIMNMX3
// takes three inputs (the rolls3 step compiles to SHFL, VIMNMX3 and
// VIMNMX alone): 0.0120 ms at 512 x 256 x 512 with 768 steps (three
// two-input maxes would be 0.0181 ms); the bytes are 0.4 MB. At one warp
// a partition the chain of dependent maxes and shuffles a step is what
// the design cannot hide.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // rows a block

// roll by one lane across the warp into y: y[k] = x[k-1] in the thread,
// y[0] from the thread before (thread 0: lane Lq-1 from the holder)
template <int R, bool RAGGED>
__device__ __forceinline__ void roll1(const int (&x)[R], int (&y)[R], int src, bool holder,
                                      int last) {
  int snd = x[R - 1];
  if (RAGGED && holder) {  // Lq-1 sits before the holder's last element
#pragma unroll
    for (int k = 0; k < R - 1; ++k) snd = k == last ? x[k] : snd;
  }
  y[0] = __shfl_sync(FULL, snd, src);
#pragma unroll
  for (int k = 1; k < R; ++k) y[k] = x[k - 1];
}

template <int R, bool ROLLS, bool RAGGED>
__global__ void __launch_bounds__(WARPS * 32)
sw_ceiling_probe_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t, int B,
                        int Lq, int Lt, int steps, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= B) return;  // a whole warp: no shuffle waits on it
  const int first = lane * R;
  const int n = min(max(Lq - first, 0), R);  // the thread's lanes inside Lq
  const int holder = (Lq - 1) / R;
  const int last = (Lq - 1) - holder * R;
  const int src = lane == 0 ? holder : lane - 1;
  const bool is_holder = lane == holder;
  const int8_t* qb = q + (size_t)row * Lq + first;
  const int8_t* tb = t + (size_t)row * Lt + first;

  int hd1[R], hd2[R], fd1[R], tj[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    hd1[k] = k < n ? qb[k] : 0;
    tj[k] = k < n ? tb[k] : 0;
    hd2[k] = 0;
    fd1[k] = 0;
  }

  auto step = [&]() {
    int a[R], b[R], c[R];
    if (ROLLS) {
      roll1<R, RAGGED>(hd2, a, src, is_holder, last);
      roll1<R, RAGGED>(fd1, b, src, is_holder, last);
      roll1<R, RAGGED>(tj, c, src, is_holder, last);
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        a[k] = max(hd2[k], 1);
        b[k] = max(fd1[k], 2);
        c[k] = max(tj[k], 3);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int h = max(max(a[k], b[k]), max(c[k], hd1[k]));
      hd2[k] = hd1[k];
      hd1[k] = h;
      fd1[k] = b[k];
      tj[k] = c[k];
    }
  };

  int s = 0;
  for (; s + R <= steps; s += R) {
#pragma unroll
    for (int u = 0; u < R; ++u) step();
  }
#pragma unroll 1
  for (; s < steps; ++s) step();

  int32_t* ob = out + (size_t)row * Lq + first;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < n) ob[k] = hd1[k];
}

template <int R>
cudaError_t launch(const int8_t* q, const int8_t* t, int B, int Lq, int Lt, int steps,
                   bool rolls, int32_t* out, cudaStream_t stream) {
  const bool ragged = Lq % R != 0;
  auto kern = rolls ? (ragged ? sw_ceiling_probe_kernel<R, true, true>
                              : sw_ceiling_probe_kernel<R, true, false>)
                    : sw_ceiling_probe_kernel<R, false, false>;
  kern<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(q, t, B, Lq, Lt, steps, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One warp a row, R lanes a thread, on ``stream``; returns the
// cudaError_t of the launch. q [B, Lq] and t [B, Lt] int8 (Lt >= Lq),
// out [B, Lq] int32, all device pointers; B > 0, 1 <= Lq <= 32 R, R in
// {1, 2, 4, 8, 16} (warp_layout.py picks it).
int sw_ceiling_probe_launch(const void* q, const void* t, int B, int Lq, int Lt, int steps,
                            int rolls, int R, void* out, void* stream) {
  if (B <= 0 || Lq < 1 || Lq > 32 * R || Lt < Lq || steps < 0)
    return (int)cudaErrorInvalidValue;
  const int8_t* qp = (const int8_t*)q;
  const int8_t* tp = (const int8_t*)t;
  int32_t* op = (int32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
    case 1: return (int)launch<1>(qp, tp, B, Lq, Lt, steps, rolls, op, s);
    case 2: return (int)launch<2>(qp, tp, B, Lq, Lt, steps, rolls, op, s);
    case 4: return (int)launch<4>(qp, tp, B, Lq, Lt, steps, rolls, op, s);
    case 8: return (int)launch<8>(qp, tp, B, Lq, Lt, steps, rolls, op, s);
    case 16: return (int)launch<16>(qp, tp, B, Lq, Lt, steps, rolls, op, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
