// int16 building blocks of an int16 Smith-Waterman state, for Hopper
// (sm_90a): the two int16 probes as one kernel, selected by an op id.
//
// Replaces the Pallas probe bodies of tools/probe_swar_i16.py (run over
// the lambdas at :56-94, k_indicator :105, k_onehot :117, k_mini :131)
// and tools/probe_swar_i16b.py (run over the lambdas at :42-64, k_mini
// :68, k_upd :107). Each op computes what its probe body computes on
// [R, W] int16 (the probes use [16, 256]); the plain versions are the
// int16 torch ops of breakmer_tpu_torch/tools/probe_swar_i16{,b}.py.
// Wrap-around equals numpy's astype(np.int16).
//
// Packing. Two batch rows share each 32-bit word: row 2r in the low
// half, row 2r+1 in the high half, at the same lane i (the row-pair
// packing pltpu.bitcast makes of int16 [16, 256] -> int32 [8, 256]). One
// block per row pair, one thread per lane: a thread loads its two int16
// values, packs them, works on both rows at once, and unpacks to store.
// A lane roll moves whole words: the block writes its words to shared
// memory, syncs, and each thread reads lane i-1 (lane 0 reads W-1).
//
// Instructions used on the packed words:
//   s16x2 SIMD: __vmaxs2 (max), __vmins2 (min), __vadd2 (add and the
//     three constant adds), __vsub2 (sub, sub const), __vcmpgts2 (the
//     compare-select the TPU probe marks "known bad"); and/or/not act on
//     the whole word.
//   Hopper DPX: __viaddmax_s16x2 for the E maxima max(h - go, e - ge),
//     __viaddmax_s16x2_relu for max(hr + sub, 0, e) (k_mini of
//     probe_swar_i16), __vibmax_s16x2 for the strict-greater update of
//     k_indicator (its predicate h > bh picks the new end; equal to the
//     TPU probe's indicator arithmetic while |h - bh| < 2^15, which the
//     probe's inputs, 0..119, keep).
//   Per half, no packed form: mul, >> 15 (arithmetic) and << 1, on the
//     two halves extracted as int16 and packed back. The i16b probe's
//     emulated max a - (d & (d >> 15)) and strict-greater select keep
//     that probe's arithmetic, with its >> 15 done per half.
//
// What bounds it on this card: nothing the op does. At [16, 256] a
// launch is 8 blocks of 256 threads and a few instructions a thread;
// the time is the launch (1.1-1.6 us of device time an op, and tens of
// us of host time a call, on an NVIDIA H100 80GB HBM3 at 700 W).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op {
  // tools/probe_swar_i16.py, in its order
  MAX, MIN, ADD, SUB_CONST, MUL, BIT_SELECT, I32_TO_I16, I16_TO_I32,
  CMP_SELECT, ROLL, INDICATOR, ONEHOT, MINI,
  // tools/probe_swar_i16b.py, in its order
  SUB, ASHR15, SHL1, ADD_SPLAT, ADD_PYINT, ADD_FULL, EMU_MAX, MINI_EMU,
  UPD_EMU, N_OPS
};

__device__ __forceinline__ uint32_t pack(int lo, int hi) {
  return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}
__device__ __forceinline__ int16_t lo16(uint32_t w) { return (int16_t)(w & 0xffffu); }
__device__ __forceinline__ int16_t hi16(uint32_t w) { return (int16_t)(w >> 16); }
__device__ __forceinline__ uint32_t splat(int v) { return pack(v, v); }

__device__ __forceinline__ uint32_t mul_halves(uint32_t a, uint32_t b) {
  return pack(lo16(a) * lo16(b), hi16(a) * hi16(b));
}
__device__ __forceinline__ uint32_t ashr15_halves(uint32_t a) {
  return pack(lo16(a) >> 15, hi16(a) >> 15);
}
__device__ __forceinline__ uint32_t shl1_halves(uint32_t a) {
  return pack((uint16_t)lo16(a) << 1, (uint16_t)hi16(a) << 1);
}
// probe_swar_i16b.emulated_max: a - (d & (d >> 15)), d = a - b
__device__ __forceinline__ uint32_t emu_max(uint32_t a, uint32_t b) {
  const uint32_t d = __vsub2(a, b);
  return __vsub2(a, d & ashr15_halves(d));
}

// roll by one lane (out[i] = x[i-1], wrapping) of the block's words
__device__ __forceinline__ uint32_t roll1(uint32_t w, uint32_t* s, int i, int W) {
  __syncthreads();  // the previous roll's readers are done with s
  s[i] = w;
  __syncthreads();
  return s[i == 0 ? W - 1 : i - 1];
}

// where(q == t, 2, -3) per element (an int32 compare), packed int16
__device__ __forceinline__ uint32_t substitution(const int32_t* q, const int32_t* t,
                                                 size_t at_lo, size_t at_hi) {
  return pack(q[at_lo] == t[at_lo] ? 2 : -3, q[at_hi] == t[at_hi] ? 2 : -3);
}

__global__ void probe_i16_kernel(int op, const void* x0, const void* x1,
                                 const void* x2, void* out, int W) {
  extern __shared__ uint32_t s[];
  const int i = threadIdx.x;
  const size_t at_lo = (size_t)(2 * blockIdx.x) * W + i;  // row 2r
  const size_t at_hi = at_lo + W;                          // row 2r + 1
  const int16_t* a16 = (const int16_t*)x0;
  const int16_t* b16 = (const int16_t*)x1;
  const int16_t* c16 = (const int16_t*)x2;
  const bool i32_in = op == I32_TO_I16 || op == MINI || op == MINI_EMU;
  uint32_t a = 0, b = 0, c = 0;
  if (!i32_in) {
    a = pack(a16[at_lo], a16[at_hi]);
    if (b16) b = pack(b16[at_lo], b16[at_hi]);
    if (c16) c = pack(c16[at_lo], c16[at_hi]);
  }
  const uint32_t six = splat(6), one = splat(1), zero = 0u;
  uint32_t r = 0;
  switch (op) {
    case MAX: r = __vmaxs2(a, b); break;
    case MIN: r = __vmins2(a, b); break;
    case ADD: r = __vadd2(a, b); break;
    case SUB_CONST: r = __vsub2(a, six); break;
    case MUL: r = mul_halves(a, b); break;
    case BIT_SELECT: r = (a & ~c) | (b & c); break;  // c: 0 / -1 mask
    case I32_TO_I16: {
      const int32_t* a32 = (const int32_t*)x0;
      r = pack(a32[at_lo], a32[at_hi]);
      break;
    }
    case I16_TO_I32: {
      int32_t* o32 = (int32_t*)out;
      o32[at_lo] = lo16(a);
      o32[at_hi] = hi16(a);
      return;
    }
    case CMP_SELECT: {
      const uint32_t m = __vcmpgts2(a, b);  // 0xffff per half where a > b
      r = (a & m) | (b & ~m);
      break;
    }
    case ROLL: r = roll1(a, s, i, W); break;
    case INDICATOR: {  // a = h, b = bh, c = bd: where(h > bh, 77, bd)
      bool ge_hi, ge_lo;  // bh >= h per half
      __vibmax_s16x2(b, a, &ge_hi, &ge_lo);
      r = pack(ge_lo ? lo16(c) : 77, ge_hi ? hi16(c) : 77);
      break;
    }
    case ONEHOT: {  // b: one-hot 0 / -1 mask of lane 0
      const uint32_t rolled = roll1(a, s, i, W);
      r = (rolled & ~b) | (splat(-42) & b);
      break;
    }
    case MINI: {
      const uint32_t sub = substitution((const int32_t*)x0, (const int32_t*)x1,
                                        at_lo, at_hi);
      const uint32_t neg_go = splat(-6);
      uint32_t h = __vmaxs2(sub, zero);
      uint32_t e = __viaddmax_s16x2(h, neg_go, __vsub2(h, one));
      for (int k = 0; k < 3; ++k) {
        const uint32_t hr = roll1(h, s, i, W);
        e = __viaddmax_s16x2(h, neg_go, __vsub2(e, one));
        h = __viaddmax_s16x2_relu(hr, sub, e);
      }
      r = h;
      break;
    }
    case SUB: r = __vsub2(a, b); break;
    case ASHR15: r = ashr15_halves(a); break;
    case SHL1: r = shl1_halves(a); break;
    case ADD_SPLAT:
    case ADD_PYINT:
    case ADD_FULL: r = __vadd2(a, six); break;  // three constant forms, one add
    case EMU_MAX: r = emu_max(a, b); break;
    case MINI_EMU: {
      const uint32_t sub = substitution((const int32_t*)x0, (const int32_t*)x1,
                                        at_lo, at_hi);
      uint32_t h = emu_max(sub, zero);
      uint32_t e = __vsub2(h, six);
      for (int k = 0; k < 3; ++k) {
        const uint32_t hr = roll1(h, s, i, W);
        e = emu_max(__vsub2(h, six), __vsub2(e, one));
        h = emu_max(emu_max(__vadd2(hr, sub), zero), e);
      }
      r = h;
      break;
    }
    case UPD_EMU: {  // a = h, b = bh, c = bd
      const uint32_t m = ashr15_halves(__vsub2(b, a));  // all ones iff bh < h
      r = (c & ~m) | (splat(77) & m);
      break;
    }
    default: return;
  }
  int16_t* o16 = (int16_t*)out;
  o16[at_lo] = lo16(r);
  o16[at_hi] = hi16(r);
}

}  // namespace

extern "C" {

// One block per row pair, one thread per lane, on ``stream``; returns the
// cudaError_t of the launch. x0..x2 and out are device pointers to
// [R, W] arrays (int16, or int32 where the op says so); x1, x2 may be
// null for ops that take fewer inputs. R even, W <= 1024.
int probe_i16_launch(int op, const void* x0, const void* x1, const void* x2,
                     void* out, int R, int W, void* stream) {
  if (op < 0 || op >= N_OPS) return (int)cudaErrorInvalidValue;
  probe_i16_kernel<<<R / 2, W, (size_t)W * 4, (cudaStream_t)stream>>>(
      op, x0, x1, x2, out, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
