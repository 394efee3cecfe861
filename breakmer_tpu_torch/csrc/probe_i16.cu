// int16 building blocks of an int16 Smith-Waterman state, for Hopper
// (sm_90a): the two int16 probes as one kernel template, instantiated for
// each lanes-a-thread RW and op id (the launcher picks one by the op id).
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
// packing pltpu.bitcast makes of int16 [16, 256] -> int32 [8, 256]): two
// alignments a word, the layout an int16x2 SW state would use.
//
// Layout. One warp a row pair, up to 8 row pairs a block (the [16, 256]
// probe is one block of 8 warps). Thread l of the warp holds the RW
// consecutive lanes l*RW .. l*RW+RW-1 of both rows as RW packed words in
// registers; RW = ceil(W / 32) rounded up to a power of two, a template
// constant in {1, 2, ..., 32} (breakmer_tpu_torch/tools/warp_layout.py
// is the same layout in Python). Register arrays are indexed by
// compile-time constants only. A thread loads its lanes of each row as
// wide loads (16 bytes a row at W = 256) and packs them with prmt
// (__byte_perm); stores unpack the same way. Where W is not a multiple
// of RW or a pointer is not aligned to the load's width, it loads and
// stores element by element instead; lanes past W are masked at load
// and store.
//
// Roll by one lane (out[i] = x[i-1], lane 0 takes lane W-1): an
// in-thread shift (register renaming once unrolled) plus one
// __shfl_sync that brings the word of lane i-1 from the thread before.
// Thread 0 takes lane W-1 from the thread that holds it; a lane past W
// never feeds it. No shared memory and no barrier: the roll, onehot and
// the three rolls of each mini-recurrence stay in the warp.
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
// What bounds it on this card: nothing the op does. At [16, 256] the
// work is 16 KB to 40 KB of loads and stores and a few instructions a
// word (bound 0.0122 us in bytes); a launch is ~0.5 us of device time,
// and a call's host launch path tens of us (breakmer_tpu_torch's
// _build.launch keeps that path lean).

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;  // row pairs a block

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
// (low halves of a and b) and (high halves of a and b) as packed words
__device__ __forceinline__ uint32_t lows(uint32_t a, uint32_t b) { return __byte_perm(a, b, 0x5410); }
__device__ __forceinline__ uint32_t highs(uint32_t a, uint32_t b) { return __byte_perm(a, b, 0x7632); }

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

// N 32-bit words at p, aligned to min(16, 4 N) bytes, as wide loads
template <int N>
__device__ __forceinline__ void ld_words(const void* p, uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = __ldg((const uint4*)p + i);
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const uint2 v = __ldg((const uint2*)p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = __ldg((const unsigned*)p);
  }
}

template <int N>
__device__ __forceinline__ void st_words(void* p, const uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      ((uint4*)p)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if constexpr (N == 2) {
    *(uint2*)p = make_uint2(w[0], w[1]);
  } else {
    *(unsigned*)p = w[0];
  }
}

// Where this thread's lanes lie: element offsets of its first lane in
// row 2r (lo) and row 2r+1 (hi), its valid lanes n (RW or 0 when vec),
// and where its roll reads from.
struct Lanes {
  size_t lo, hi;
  int n;
  bool vec;     // wide loads and stores (W % RW == 0, pointers aligned)
  int src;      // the thread whose word feeds this thread's lane 0
  bool holder;  // holds lane W-1, which it sends to thread 0
  int last;     // lane W-1's element in the holder
};

// the thread's RW lanes of both int16 rows as packed words (0 past W)
template <int RW>
__device__ __forceinline__ void ld_i16(const void* x, const Lanes& ln, uint32_t (&w)[RW]) {
  const int16_t* p = (const int16_t*)x;
  if constexpr (RW >= 2) {
    if (ln.vec) {
      uint32_t l[RW / 2], h[RW / 2];
      if (ln.n == 0) {
#pragma unroll
        for (int k = 0; k < RW; ++k) w[k] = 0;
        return;
      }
      ld_words(p + ln.lo, l);
      ld_words(p + ln.hi, h);
#pragma unroll
      for (int k = 0; k < RW / 2; ++k) {
        w[2 * k] = lows(l[k], h[k]);
        w[2 * k + 1] = highs(l[k], h[k]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < RW; ++k) w[k] = k < ln.n ? pack(p[ln.lo + k], p[ln.hi + k]) : 0u;
}

// the thread's RW lanes of both int32 rows, unpacked (0 past W)
template <int RW>
__device__ __forceinline__ void ld_i32(const void* x, const Lanes& ln, uint32_t (&l)[RW],
                                       uint32_t (&h)[RW]) {
  const int32_t* p = (const int32_t*)x;
  if (ln.vec) {
    if (ln.n == RW) {
      ld_words(p + ln.lo, l);
      ld_words(p + ln.hi, h);
    } else {
#pragma unroll
      for (int k = 0; k < RW; ++k) l[k] = h[k] = 0;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    l[k] = k < ln.n ? (uint32_t)p[ln.lo + k] : 0u;
    h[k] = k < ln.n ? (uint32_t)p[ln.hi + k] : 0u;
  }
}

// where(q == t, 2, -3) per element (an int32 compare), packed int16
template <int RW>
__device__ __forceinline__ void substitution(const void* q, const void* t, const Lanes& ln,
                                             uint32_t (&sub)[RW]) {
  uint32_t ql[RW], qh[RW], tl[RW], th[RW];
  ld_i32(q, ln, ql, qh);
  ld_i32(t, ln, tl, th);
#pragma unroll
  for (int k = 0; k < RW; ++k) sub[k] = pack(ql[k] == tl[k] ? 2 : -3, qh[k] == th[k] ? 2 : -3);
}

template <int RW>
__device__ __forceinline__ void st_i16(void* out, const Lanes& ln, const uint32_t (&w)[RW]) {
  int16_t* p = (int16_t*)out;
  if constexpr (RW >= 2) {
    if (ln.vec) {
      if (ln.n == 0) return;
      uint32_t l[RW / 2], h[RW / 2];
#pragma unroll
      for (int k = 0; k < RW / 2; ++k) {
        l[k] = lows(w[2 * k], w[2 * k + 1]);
        h[k] = highs(w[2 * k], w[2 * k + 1]);
      }
      st_words(p + ln.lo, l);
      st_words(p + ln.hi, h);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    if (k < ln.n) {
      p[ln.lo + k] = lo16(w[k]);
      p[ln.hi + k] = hi16(w[k]);
    }
  }
}

template <int RW>
__device__ __forceinline__ void st_i32(void* out, const Lanes& ln, const uint32_t (&w)[RW]) {
  int32_t* p = (int32_t*)out;
  uint32_t l[RW], h[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    l[k] = (uint32_t)(int32_t)lo16(w[k]);
    h[k] = (uint32_t)(int32_t)hi16(w[k]);
  }
  if (ln.vec) {
    if (ln.n == RW) {
      st_words(p + ln.lo, l);
      st_words(p + ln.hi, h);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    if (k < ln.n) {
      p[ln.lo + k] = (int32_t)l[k];
      p[ln.hi + k] = (int32_t)h[k];
    }
  }
}

// roll by one lane across the warp: x[k] = x[k-1] in the thread, and
// lane 0 of the thread takes the word the thread before sends (thread 0:
// lane W-1 from the holder). Every thread of the warp takes part.
template <int RW>
__device__ __forceinline__ void roll1(uint32_t (&x)[RW], const Lanes& ln) {
  uint32_t snd = x[RW - 1];
  if (ln.holder) {  // W-1 may sit before the holder's last element
#pragma unroll
    for (int k = 0; k < RW - 1; ++k) snd = k == ln.last ? x[k] : snd;
  }
  const uint32_t in = __shfl_sync(FULL, snd, ln.src);
#pragma unroll
  for (int k = RW - 1; k > 0; --k) x[k] = x[k - 1];
  x[0] = in;
}

// one instantiation a (RW, op): a launch runs only its op's code, a few
// hundred instructions, not the ~3,200 of all 22 ops in one body
template <int RW, int OP>
__global__ void __launch_bounds__(MAX_WARPS * 32)
probe_i16_kernel(const void* __restrict__ x0, const void* __restrict__ x1,
                 const void* __restrict__ x2, void* __restrict__ out, int P, int W, bool vec) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= P) return;  // a whole warp: no shuffle waits on it
  const int first = lane * RW;
  Lanes ln;
  ln.lo = (size_t)(2 * pair) * W + first;
  ln.hi = ln.lo + W;
  ln.n = min(max(W - first, 0), RW);
  ln.vec = vec;
  const int holder = (W - 1) / RW;
  ln.src = lane == 0 ? holder : lane - 1;
  ln.holder = lane == holder;
  ln.last = (W - 1) - holder * RW;

  const uint32_t six = splat(6), one = splat(1), zero = 0u;
  uint32_t a[RW], b[RW], c[RW], r[RW];  // inputs, then r the result
  switch (OP) {
    case I32_TO_I16: {
      ld_i32(x0, ln, a, b);
#pragma unroll
      for (int k = 0; k < RW; ++k) r[k] = lows(a[k], b[k]);
      break;
    }
    case MINI: {
      substitution(x0, x1, ln, c);  // c = sub
      const uint32_t neg_go = splat(-6);
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        r[k] = __vmaxs2(c[k], zero);                                // h
        a[k] = __viaddmax_s16x2(r[k], neg_go, __vsub2(r[k], one));  // e
      }
#pragma unroll 1
      for (int it = 0; it < 3; ++it) {
#pragma unroll
        for (int k = 0; k < RW; ++k) b[k] = r[k];
        roll1(b, ln);  // hr
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          a[k] = __viaddmax_s16x2(r[k], neg_go, __vsub2(a[k], one));
          r[k] = __viaddmax_s16x2_relu(b[k], c[k], a[k]);
        }
      }
      break;
    }
    case MINI_EMU: {
      substitution(x0, x1, ln, c);  // c = sub
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        r[k] = emu_max(c[k], zero);  // h
        a[k] = __vsub2(r[k], six);   // e
      }
#pragma unroll 1
      for (int it = 0; it < 3; ++it) {
#pragma unroll
        for (int k = 0; k < RW; ++k) b[k] = r[k];
        roll1(b, ln);  // hr
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          a[k] = emu_max(__vsub2(r[k], six), __vsub2(a[k], one));
          r[k] = emu_max(emu_max(__vadd2(b[k], c[k]), zero), a[k]);
        }
      }
      break;
    }
    default: {
      // every other op takes int16 inputs: x0 always, x1 and x2 if given
      ld_i16(x0, ln, a);
#pragma unroll
      for (int k = 0; k < RW; ++k) b[k] = c[k] = 0;
      if (x1) ld_i16(x1, ln, b);
      if (x2) ld_i16(x2, ln, c);
      // r[k] = f(a[k], b[k], c[k]) over the thread's words
      auto each = [&](auto f) {
#pragma unroll
        for (int k = 0; k < RW; ++k) r[k] = f(a[k], b[k], c[k]);
      };
      using u32 = uint32_t;
      switch (OP) {
        case MAX: each([](u32 x, u32 y, u32) { return __vmaxs2(x, y); }); break;
        case MIN: each([](u32 x, u32 y, u32) { return __vmins2(x, y); }); break;
        case ADD: each([](u32 x, u32 y, u32) { return __vadd2(x, y); }); break;
        case SUB_CONST: each([=](u32 x, u32, u32) { return __vsub2(x, six); }); break;
        case MUL: each([](u32 x, u32 y, u32) { return mul_halves(x, y); }); break;
        case BIT_SELECT:  // z: 0 / -1 mask
          each([](u32 x, u32 y, u32 z) { return (x & ~z) | (y & z); });
          break;
        case I16_TO_I32:
          st_i32(out, ln, a);
          return;
        case CMP_SELECT:
          each([](u32 x, u32 y, u32) {
            const u32 m = __vcmpgts2(x, y);  // 0xffff per half where x > y
            return (x & m) | (y & ~m);
          });
          break;
        case ROLL:
          roll1(a, ln);
          each([](u32 x, u32, u32) { return x; });
          break;
        case INDICATOR:  // x = h, y = bh, z = bd: where(h > bh, 77, bd)
          each([](u32 x, u32 y, u32 z) {
            bool ge_hi, ge_lo;  // bh >= h per half
            __vibmax_s16x2(y, x, &ge_hi, &ge_lo);
            return pack(ge_lo ? lo16(z) : 77, ge_hi ? hi16(z) : 77);
          });
          break;
        case ONEHOT:  // y: one-hot 0 / -1 mask of lane 0
          roll1(a, ln);
          each([](u32 x, u32 y, u32) { return (x & ~y) | (splat(-42) & y); });
          break;
        case SUB: each([](u32 x, u32 y, u32) { return __vsub2(x, y); }); break;
        case ASHR15: each([](u32 x, u32, u32) { return ashr15_halves(x); }); break;
        case SHL1: each([](u32 x, u32, u32) { return shl1_halves(x); }); break;
        case ADD_SPLAT:
        case ADD_PYINT:
        case ADD_FULL:  // three constant forms, one add
          each([=](u32 x, u32, u32) { return __vadd2(x, six); });
          break;
        case EMU_MAX: each([](u32 x, u32 y, u32) { return emu_max(x, y); }); break;
        case UPD_EMU:  // x = h, y = bh, z = bd
          each([](u32 x, u32 y, u32 z) {
            const u32 m = ashr15_halves(__vsub2(y, x));  // all ones iff bh < h
            return (z & ~m) | (splat(77) & m);
          });
          break;
        default: return;
      }
    }
  }
  st_i16(out, ln, r);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || (uintptr_t)p % (uintptr_t)bytes == 0;
}

using Kernel = void (*)(const void*, const void*, const void*, void*, int, int, bool);

// the instantiations of one RW, indexed by op
template <int RW, int... OPS>
const Kernel* kernels(std::integer_sequence<int, OPS...>) {
  static const Kernel table[] = {probe_i16_kernel<RW, OPS>...};
  return table;
}

template <int RW>
cudaError_t launch(int op, const void* x0, const void* x1, const void* x2, void* out, int R,
                   int W, cudaStream_t stream) {
  const int in_bytes = (op == I32_TO_I16 || op == MINI || op == MINI_EMU) ? 4 : 2;
  const int out_bytes = op == I16_TO_I32 ? 4 : 2;
  const int in_align = in_bytes * RW < 16 ? in_bytes * RW : 16;
  const int out_align = out_bytes * RW < 16 ? out_bytes * RW : 16;
  const bool vec = W % RW == 0 && aligned(x0, in_align) && aligned(x1, in_align) &&
                   aligned(x2, in_align) && aligned(out, out_align);
  const int P = R / 2;
  const int warps = P < MAX_WARPS ? P : MAX_WARPS;
  const Kernel kern = kernels<RW>(std::make_integer_sequence<int, N_OPS>{})[op];
  kern<<<(P + warps - 1) / warps, warps * 32, 0, stream>>>(x0, x1, x2, out, P, W, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One warp a row pair, RW lanes a thread, on ``stream``; returns the
// cudaError_t of the launch. x0..x2 and out are device pointers to
// [R, W] arrays (int16, or int32 where the op says so); x1, x2 may be
// null for ops that take fewer inputs. R even and > 0, 1 <= W <= 32 RW,
// RW in {1, 2, 4, 8, 16, 32} (warp_layout.py picks it).
int probe_i16_launch(int op, const void* x0, const void* x1, const void* x2, void* out,
                     int R, int W, int RW, void* stream) {
  if (op < 0 || op >= N_OPS || R <= 0 || R % 2 || W < 1 || W > 32 * RW)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (RW) {
    case 1: return (int)launch<1>(op, x0, x1, x2, out, R, W, s);
    case 2: return (int)launch<2>(op, x0, x1, x2, out, R, W, s);
    case 4: return (int)launch<4>(op, x0, x1, x2, out, R, W, s);
    case 8: return (int)launch<8>(op, x0, x1, x2, out, R, W, s);
    case 16: return (int)launch<16>(op, x0, x1, x2, out, R, W, s);
    case 32: return (int)launch<32>(op, x0, x1, x2, out, R, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
