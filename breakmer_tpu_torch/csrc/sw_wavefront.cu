// Batched affine-gap Smith-Waterman as a warp-synchronous wavefront in
// registers, for Hopper (sm_90a), in two launch forms: the ticket form
// (below) for launches of many pairs, and the block form (its own note,
// after the ticket form's) for launches of a few.
//
// Replaces breakmer_tpu/ops/sw_pallas.py::_sw_kernel (launched by
// sw_score_pallas). It computes what the plain version computes
// (breakmer_tpu_torch/ops/sw.py::sw_score, itself the scan of
// breakmer_tpu/ops/sw.py): per (query, target) pair the best H cell and
// its end coordinates, tie-broken by (score desc, i + j asc, i asc); a
// best score <= 0 gives (0, -1, -1). A gap of length g costs
// gap_open + gap_extend * g; a code >= 4 (N or pad) scores NEG.
//
// Design (the ticket form). The query rows of a pair are cut into strips of 32 * R rows
// (R = rows a lane, a template constant: 4 or 8). One warp sweeps one
// strip over every target column. Lane l owns R consecutive rows and keeps
// their H and E of the previous column in registers; it runs l steps
// behind lane 0, so at step s it computes column j = s - l. After each
// step the H and F of a lane's bottom row pass to lane l + 1 with
// __shfl_up_sync: exactly the "row above" that lane needs at the next
// step; the value passed the step before is its diagonal. The cell loop
// has no barrier and no shared-memory access, and the steps in which every
// lane is inside the matrix (all but the first and last 32) run without a
// bounds test.
//
// What bounds it on this card: integer issue. Each SM partition issues 16
// int32 lanes a clock (64 an SM), so a warp instruction of the integer
// pipe takes two clocks, and the sweep is a chain of them. Per cell the
// packed no_n form executes
//   sub = byte tc of a per-step score table, selected by
//         the row's query code (prmt)                         1
//   E'  = __viaddmax_s32(H_left, ge*j - go, E'_left)           1
//   F   = __viaddmax_s32(H_up, -go, F_up - ge)                 2
//   H   = __viaddmax_s32_relu(H_diag, sub,
//                             __viaddmax_s32(E', -ge*j, F))    2
//   best of the row: max(key, H * 2^16 + 65535 - j)            1 (+1 imad)
// that is 7 operations a cell on the integer pipe; the key's multiply-add
// (key_scale is a run-time argument, so it stays an IMAD) issues on the
// FMA pipe at the same rate beside them, one a cell, so it never bounds
// the sweep: OPS = 7 for the bound. E' = E + ge * j is E without its
// per-column drift, so it needs no add of its own; the packed key keeps
// the first column of a row's best in one max. (The unpacked form
// computes E = __viaddmax_s32(H_left, -go, E_left - ge) and keeps the
// column apart: 8 or 9 operations a cell.) The bound of a launch is
// B * Lq * Lt * OPS over (SMs * 64 * SM clock). Inputs and outputs are
// B * (Lq + Lt) + 12 * B bytes, so the bound is compute, not memory. The
// steps add a fixed cost (the shuffles, the table, the loop), so a larger
// R is cheaper a cell; a smaller R gives more warps to a launch with few
// pairs. The wrapper (ops/sw_cuda.py::launch_plan) weighs the two.
//
// Strips of one pair. Strip k needs the bottom row (H and F) of strip
// k - 1. Its warp writes that row to a global buffer as it goes, one
// 16-byte line a column, (H, j + 1, F, j + 1), with a single volatile
// store: each 8-byte half carries its own stamp (the low-latency protocol
// of NCCL's LL lines), so the reader needs no fence and no flag, only a
// zeroed buffer. The warp of strip k loads the row 16 columns at a time,
// one chunk ahead, and spins on a line until both stamps are its column:
// it runs about 31 + 32 steps behind the strip above, plus the time a
// line takes to show.
// No block barrier is used: every warp takes its work item from an atomic
// ticket, in (pair, strip) order, so the strip it waits on belongs to a
// warp that already runs. So a long query (2 x 10240 rows) keeps many
// warps busy instead of one block a pair, and a short one (Lq <= 32 * R)
// is one warp a pair, four pairs a block of 128 threads, with no scratch.
// A strip's best goes to a slot; the pair's last strip to finish (an
// atomic count) reduces the slots. The buffer holds B * (S - 1) * Lt * 16
// bytes (cells / (2 R)).
//
// The target. Lane 0 takes the code of its column from a register chunk
// of 16 codes that the warp loads with one coalesced read (prefetched a
// chunk ahead) and passes it down the lanes with the same
// shuffle as H and F. So every target byte is read once per strip,
// without shared memory or cp.async, whose staging would need a block
// barrier that the warps of different pairs do not share.
//
// Exactness. Boundaries as in the plain version: column j == 0 has no
// left neighbour (diagonal 0, E = NEG: the E addend of that step is NEG
// and E' starts at NEG, H at 0), row i == 0 has H_up = F_up = NEG and
// diagonal 0. Rows past Lq in the last strip compute values that feed
// only rows below them and are left out of the best; lanes outside
// 0 <= j < Lt do nothing and pass on what they had (H 0 before column 0,
// which is the diagonal of column 0). Within a row the cells are visited
// in increasing j, hence increasing i + j, so the first best of a row is
// the one to keep; the rows, lanes, strips and the pair are then reduced
// on the full key (score desc, i + j asc, i asc). The packed form
// (PACK) needs every H below 2^15, Lt <= 2^16 and E' = E + ge * j inside
// int32; the wrapper takes it only where a bound of H that holds for any
// sign of any parameter says so (ops/sw_cuda.py::packs), and past that the
// kernel keeps score and column apart and E as the plain version does
// (PACK = false): the plain version's own int32 operations, cell for
// cell. no_n (every code a base 0-3 or a trailing pad) re-encodes the
// codes outside 0-3 to never-matching ones (query 6, target 7) and drops
// the N test from the substitution; the outputs are bit-identical (see
// sw_pallas.py's no_n proof); its score table holds bytes read back
// sign-extended, so the wrapper takes it only for match and -mismatch
// within int8.

//
// The block form (sw_wavefront_block_kernel). A launch of few pairs leaves
// the ticket form a few warps on the whole card, each strip 127-149 steps
// behind the one above. Here one block holds one pair: S warps, one a
// strip of 32 * R rows (R = 2, so S <= 32 while Lq <= 2048), and B
// pairs are B blocks. The cell loop is the ticket form's (sw_cells).
//   - The target is staged in shared memory once, with 16-byte loads,
//     before the block's one barrier; the sentinel 7 pads 32 columns
//     before it and 48 past it, so lane l reads the code of its own
//     column s - l at step s without a test, HAND codes at a time.
//   - Strip k hands the bottom row of its lane 31 (H, F of each column)
//     to strip k + 1 through a ring of RING columns in shared memory.
//     The handoffs happen between chunks of HAND steps, in code the whole
//     warp runs: at a chunk's start lane 31 publishes the columns it has
//     written (a release store of a block-scope count), lane 0 releases
//     the slots it read for the chunk before (a second count), and the
//     warp waits (acquire loads) for the slots its lane 31 is about to
//     write to be free and for the columns its lane 0 is about to read
//     to be written; lane 0 loads those into registers. RING > HAND keeps
//     the two waits from closing a cycle. Strip k + 1 runs 32 + HAND steps
//     behind strip k, not 127-149; the steps never wait, and the sweep has
//     no block barrier.
//   - The 32 steps in which the lanes ramp in and the 31 in which they
//     ramp out run without a branch: every lane computes its cells, and
//     one outside the matrix keeps its previous state: these steps are
//     on the path of every strip, and a divergent branch in each made
//     them far slower than a step inside the matrix.
//   - Each strip's best goes to a shared slot; after the block's second
//     barrier warp 0 reduces the S slots. No ticket, no scratch.
// A wait that lasts SPIN_LIMIT polls traps (the launch fails) instead of
// hanging the card.

#include <cstdint>
#include <climits>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 128;
constexpr int CHUNK = 16;  // columns a boundary and target load brings
// the block form
constexpr int BLOCK_MAX_THREADS = 1024;  // 32 strips of one warp
constexpr int RING = 64;  // columns a strip boundary's ring holds
constexpr int HAND = 8;   // columns a strip publishes, and takes, at once
constexpr int TPAD = 32;  // sentinel columns before the staged target
constexpr int TTAIL = 48;  // and past it (the lane ramp and one HAND)
constexpr unsigned SPIN_LIMIT = 1u << 26;
static_assert(RING > HAND && (RING & (RING - 1)) == 0 && 32 % HAND == 0,
              "ring and handoff sizes");

__device__ __forceinline__ int prmt(int a, int b, int sel) {
  int d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ int4 load_line(const int4* p) {
  int4 v;
  asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_line(int4* p, int4 v) {
  asm volatile("st.volatile.global.v4.s32 [%0], {%1, %2, %3, %4};"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// block-scope counters in shared memory
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v) : "r"((unsigned)__cvta_generic_to_shared(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;"
               ::"r"((unsigned)__cvta_generic_to_shared(p)), "r"(v) : "memory");
}

__device__ __forceinline__ void wait_at_least(const int* p, int need) {
  for (unsigned n = 0; load_acquire(p) < need; ++n) {
    if (n == SPIN_LIMIT) __trap();
  }
}

// (s2, d2, i2) before (s, d, i) on (score desc, d asc, i asc)
__device__ __forceinline__ bool better(int s2, int d2, int i2, int s, int d, int i) {
  return s2 > s || (s2 == s && (d2 < d || (d2 == d && i2 < i)));
}

// The query codes of a lane's R rows from row0 (qs: the code, or (no_n)
// the prmt selector of its byte in the score table, sign-extended) and
// the rows' starting state.
template <int R, bool NO_N>
__device__ __forceinline__ void init_rows(const int8_t* qb, int row0, int Lq, int (&qs)[R],
                                          int (&H)[R], int (&E)[R], int (&bk)[R],
                                          int (&bj)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    int c = i < Lq ? qb[i] : 4;
    if (NO_N) {
      c = (unsigned)c >= 4u ? 6 : c;  // N, pad or a code below 0: the query's pad
      qs[r] = c | ((8 | c) << 4) | ((8 | c) << 8) | ((8 | c) << 12);
    } else {
      qs[r] = c;
    }
    H[r] = 0;
    E[r] = NEG;
    bk[r] = 0;
    bj[r] = -1;
  }
}

// One column j of a lane's R rows: tc is the column's target code, hu and
// fu the H and F of the row above (updated to the lane's bottom row), dg
// its diagonal. Both forms run this cell loop.
template <int R, bool NO_N, bool PACK, bool CHECK>
__device__ __forceinline__ void sw_cells(int j, int tc, int& hu, int& fu, int dg,
                                         const int (&qs)[R], int (&H)[R], int (&E)[R],
                                         int (&bk)[R], int (&bj)[R], int go, int ge,
                                         int match, int mismatch, int nm4, int xm,
                                         int key_scale) {
  // packed: E' addend (none at j == 0), E = E' + ce, the key's column
  int ea = ge * j - go;
  if (CHECK && j == 0) ea = NEG;
  const int ce = -ge * j;
  const int cj = 65535 - j;
  int tlo = 0, thi = 0, eqv = 0, nev = 0;
  if (NO_N) {
    tlo = tc < 4 ? nm4 ^ (xm << (8 * tc)) : nm4;
    thi = nm4;
  } else {
    eqv = tc >= 4 ? NEG : match;
    nev = tc >= 4 ? NEG : -mismatch;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int sub;
    if (NO_N) {
      sub = prmt(tlo, thi, qs[r]);
    } else {
      sub = qs[r] == tc ? eqv : nev;
      if (qs[r] >= 4) sub = NEG;
    }
    const int f = __viaddmax_s32(hu, -go, fu - ge);
    int e, h;
    if (PACK) {
      e = __viaddmax_s32(H[r], ea, E[r]);
      h = __viaddmax_s32_relu(dg, sub, __viaddmax_s32(e, ce, f));
      bk[r] = max(bk[r], h * key_scale + cj);
    } else {  // the plain version's own operations: E from H - go and E - ge
      e = __viaddmax_s32(H[r], -go, E[r] - ge);
      if (CHECK && j == 0) e = NEG;
      h = __viaddmax_s32_relu(dg, sub, max(e, f));
      bool keep;
      bk[r] = __vibmax_s32(bk[r], h, &keep);
      bj[r] = keep ? bj[r] : j;
    }
    dg = H[r];
    H[r] = h;
    E[r] = e;
    hu = h;
    fu = f;
  }
}

// The best of a warp's strip on the full key, in every lane: the rows of
// each lane, then the warp.
template <int R, bool PACK>
__device__ __forceinline__ void strip_best(int row0, int Lq, const int (&bk)[R],
                                           const int (&bj)[R], int& best_s, int& best_d,
                                           int& best_i) {
  best_s = 0;
  best_d = best_i = INT_MAX;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    const int s = PACK ? bk[r] >> 16 : bk[r];
    const int j = PACK ? 65535 - (bk[r] & 65535) : bj[r];
    if (i < Lq && better(s, i + j, i, best_s, best_d, best_i)) {
      best_s = s;
      best_d = i + j;
      best_i = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int s2 = __shfl_down_sync(FULL, best_s, off);
    const int d2 = __shfl_down_sync(FULL, best_d, off);
    const int i2 = __shfl_down_sync(FULL, best_i, off);
    if (better(s2, d2, i2, best_s, best_d, best_i)) {
      best_s = s2;
      best_d = d2;
      best_i = i2;
    }
  }
}

__device__ __forceinline__ void write_best(int b, int best_s, int best_d, int best_i,
                                           int32_t* out_score, int32_t* out_qend,
                                           int32_t* out_tend) {
  const bool none = best_s <= 0;
  out_score[b] = none ? 0 : best_s;
  out_qend[b] = none ? -1 : best_i;
  out_tend[b] = none ? -1 : best_d - best_i;
}

// header (when S > 1, zeroed): [ticket, done[B], partial[3 * B * S]] int32;
// bnd (when S > 1, zeroed): [B * (S - 1) * Lt] lines (H, j + 1, F, j + 1).
template <int R, bool NO_N, bool PACK>
__global__ void __launch_bounds__(MAX_THREADS) sw_wavefront_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ t, int B, int Lq, int Lt,
    int match, int mismatch, int gap_open, int gap_extend, int key_scale, int* header,
    int4* bnd, int32_t* __restrict__ out_score, int32_t* __restrict__ out_qend,
    int32_t* __restrict__ out_tend) {
  const int lane = threadIdx.x & 31;
  const int S = (Lq + 32 * R - 1) / (32 * R);
  const int n_items = B * S;
  int item;
  if (S == 1) {
    item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  } else {
    int ticket = 0;
    if (lane == 0) ticket = atomicAdd(header, 1);
    item = __shfl_sync(FULL, ticket, 0);
  }
  if (item >= n_items) return;  // warp-uniform
  const int b = item / S;
  const int k = item - b * S;
  const bool has_in = k > 0;
  const bool has_out = k + 1 < S;
  const int4* bin = has_in ? bnd + ((size_t)b * (S - 1) + (k - 1)) * Lt : nullptr;
  int4* bout = has_out ? bnd + ((size_t)b * (S - 1) + k) * Lt : nullptr;

  const int go = gap_open + gap_extend;
  const int ge = gap_extend;
  const int row0 = k * 32 * R + lane * R;
  const int8_t* qb = q + (size_t)b * Lq;
  const int8_t* tb = t + (size_t)b * Lt;

  // bk: the row's best (packed key, or score)
  int qs[R], H[R], E[R], bk[R], bj[R];
  init_rows<R, NO_N>(qb, row0, Lq, qs, H, E, bk, bj);
  // no_n score table: 8 bytes of -mismatch, byte tc (< 4) holds match
  const int nm4 = (int)(0x01010101u * ((unsigned)(-mismatch) & 0xffu));
  const int xm = (int)(((unsigned)match ^ (unsigned)(-mismatch)) & 0xffu);

  // chunks of CHUNK columns, lane l holding column c0 + l (lanes < CHUNK)
  auto t_chunk = [&](int c0) {
    const int j = c0 + lane;
    int c = lane < CHUNK && j < Lt ? (int)__ldg(tb + j) : 7;
    if (NO_N && (unsigned)c >= 4u) c = 7;
    return c;
  };
  auto b_chunk = [&](int c0) {  // H, F above the strip at column c0 + lane
    const int j = c0 + lane;
    if (!has_in || lane >= CHUNK || j >= Lt) return make_int2(NEG, NEG);
    int4 v = load_line(bin + j);
    while (v.y != j + 1 || v.w != j + 1) {
      __nanosleep(32);
      v = load_line(bin + j);
    }
    return make_int2(v.x, v.z);
  };

  int t_cur = t_chunk(0), t_nxt = t_chunk(CHUNK);
  int2 b_cur = b_chunk(0), b_nxt = b_chunk(CHUNK);
  const bool top = lane == 0 && k == 0;  // row 0 of the matrix: diagonal 0
  int tc = 0, uh = 0, uf = NEG, dtop = 0;  // target code; H, F above; diagonal
  int snd_h = 0, snd_f = NEG;  // H, F of the lane's bottom row, last column

  auto step = [&](int s, auto check) {
    constexpr bool CHECK = decltype(check)::value;
    // lane 0 takes column s from the chunks; the others got theirs last step
    const int src = s & (CHUNK - 1);
    const int in_t = __shfl_sync(FULL, t_cur, src);
    int in_h = NEG, in_f = NEG;
    if (has_in) {
      in_h = __shfl_sync(FULL, b_cur.x, src);
      in_f = __shfl_sync(FULL, b_cur.y, src);
    }
    if (lane == 0) {
      dtop = top ? 0 : uh;
      uh = in_h;
      uf = in_f;
      tc = in_t;
    }
    const int j = s - lane;
    bool active = true;
    if (CHECK) active = j >= 0 && j < Lt;
    if (active) {
      int hu = uh, fu = uf;
      sw_cells<R, NO_N, PACK, CHECK>(j, tc, hu, fu, dtop, qs, H, E, bk, bj, go, ge, match,
                                     mismatch, nm4, xm, key_scale);
      snd_h = hu;
      snd_f = fu;
      if (has_out && lane == 31) store_line(bout + j, make_int4(hu, j + 1, fu, j + 1));
    }
    const int up_h = __shfl_up_sync(FULL, snd_h, 1);
    const int up_f = __shfl_up_sync(FULL, snd_f, 1);
    const int up_t = __shfl_up_sync(FULL, tc, 1);
    if (lane != 0) {
      dtop = uh;
      uh = up_h;
      uf = up_f;
      tc = up_t;
    }
  };

  const int n_steps = Lt + 31;
  for (int s0 = 0; s0 < n_steps; s0 += CHUNK) {
    if (s0 > 0) {
      t_cur = t_nxt;
      b_cur = b_nxt;
      if (s0 + CHUNK < Lt) {
        t_nxt = t_chunk(s0 + CHUNK);
        b_nxt = b_chunk(s0 + CHUNK);
      }
    }
    const int s1 = min(s0 + CHUNK, n_steps);
    if (s0 >= 32 && s0 + CHUNK <= Lt) {  // every lane inside the matrix
      for (int s = s0; s < s1; ++s) step(s, std::false_type());
    } else {
      for (int s = s0; s < s1; ++s) step(s, std::true_type());
    }
  }

  int best_s, best_d, best_i;
  strip_best<R, PACK>(row0, Lq, bk, bj, best_s, best_d, best_i);
  if (lane != 0) return;
  if (S > 1) {
    int* done = header + 1;
    int* partial = done + B;
    int* slot = partial + 3 * item;
    slot[0] = best_s;
    slot[1] = best_d;
    slot[2] = best_i;
    __threadfence();
    if (atomicAdd(done + b, 1) != S - 1) return;  // not the pair's last strip
    __threadfence();
    best_s = 0;
    best_d = best_i = INT_MAX;
    for (int kk = 0; kk < S; ++kk) {
      const int* p = partial + 3 * (b * S + kk);
      const int s2 = __ldcg(p), d2 = __ldcg(p + 1), i2 = __ldcg(p + 2);
      if (better(s2, d2, i2, best_s, best_d, best_i)) {
        best_s = s2;
        best_d = d2;
        best_i = i2;
      }
    }
  }
  write_best(b, best_s, best_d, best_i, out_score, out_qend, out_tend);
}

// The block form's shared memory: [ring (S - 1) x RING int2][ready, taken
// (S - 1) int32 each][slot 3 S int32], padded to 16 bytes, then the
// staged target [TPAD + Lt + TTAIL] bytes, padded to 16.
__host__ __device__ constexpr int block_head_bytes(int S) {
  return (8 * RING * (S - 1) + 8 * (S - 1) + 12 * S + 15) / 16 * 16;
}

__host__ __device__ constexpr int block_smem_bytes(int S, int Lt) {
  return block_head_bytes(S) + (TPAD + Lt + TTAIL + 15) / 16 * 16;
}

// A word of 4 target codes in the no_n form: a byte >= 4 (N or pad) or
// below 0 becomes 7 (the byte's bit 7, or a carry into it from bits 2-6).
__device__ __forceinline__ unsigned no_n_word(unsigned w) {
  const unsigned big = (((w & 0x7c7c7c7cu) + 0x7c7c7c7cu) | w) & 0x80808080u;
  const unsigned mask = (big >> 7) * 0xffu;
  return (w & ~mask) | (0x07070707u & mask);
}

// tg[0 .. TPAD + Lt + TTAIL): 7, then the pair's target codes (no_n: a
// code outside 0-3 as 7), then 7; by the whole block, 16 bytes a thread where
// the row is 16-byte aligned.
template <bool NO_N>
__device__ __forceinline__ void stage_target(const int8_t* tb, int Lt, int8_t* tg) {
  int vec = 0;  // columns staged as 16-byte words
  if ((reinterpret_cast<uintptr_t>(tb) & 15) == 0) {
    vec = Lt / 16;
    const int4* src = reinterpret_cast<const int4*>(tb);
    int4* dst = reinterpret_cast<int4*>(tg + TPAD);
    for (int v = threadIdx.x; v < vec; v += blockDim.x) {
      int4 w = __ldg(src + v);
      if (NO_N) {
        w.x = (int)no_n_word((unsigned)w.x);
        w.y = (int)no_n_word((unsigned)w.y);
        w.z = (int)no_n_word((unsigned)w.z);
        w.w = (int)no_n_word((unsigned)w.w);
      }
      dst[v] = w;
    }
    vec *= 16;
  }
  for (int i = threadIdx.x; i < TPAD + Lt + TTAIL; i += blockDim.x) {
    const int j = i - TPAD;
    if (j >= 0 && j < vec) continue;
    int c = j >= 0 && j < Lt ? (int)__ldg(tb + j) : 7;
    if (NO_N && (unsigned)c >= 4u) c = 7;
    tg[i] = (int8_t)c;
  }
}

// One block a pair (blockIdx.x), one warp a strip of 32 R rows; blockDim.x
// = 32 S, shared memory block_smem_bytes(S, Lt).
template <int R, bool NO_N, bool PACK>
__global__ void __launch_bounds__(BLOCK_MAX_THREADS) sw_wavefront_block_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ t, int Lq, int Lt, int match,
    int mismatch, int gap_open, int gap_extend, int key_scale,
    int32_t* __restrict__ out_score, int32_t* __restrict__ out_qend,
    int32_t* __restrict__ out_tend) {
  extern __shared__ int4 smem[];
  const int S = blockDim.x >> 5;
  const int k = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  int2* ring = reinterpret_cast<int2*>(smem);
  int* ready = reinterpret_cast<int*>(ring + RING * (S - 1));  // columns published
  int* taken = ready + (S - 1);  // columns loaded by the strip below
  int* slot = taken + (S - 1);   // each strip's best
  int8_t* tg = reinterpret_cast<int8_t*>(smem) + block_head_bytes(S);

  stage_target<NO_N>(t + (size_t)b * Lt, Lt, tg);
  for (int i = threadIdx.x; i < S - 1; i += blockDim.x) ready[i] = taken[i] = 0;
  __syncthreads();

  const bool has_in = k > 0;
  const bool has_out = k + 1 < S;
  const int2* rin = has_in ? ring + RING * (k - 1) : nullptr;
  int2* rout = has_out ? ring + RING * k : nullptr;
  const int go = gap_open + gap_extend;
  const int ge = gap_extend;
  const int row0 = k * 32 * R + lane * R;

  int qs[R], H[R], E[R], bk[R], bj[R];
  init_rows<R, NO_N>(q + (size_t)b * Lq, row0, Lq, qs, H, E, bk, bj);
  const int nm4 = (int)(0x01010101u * ((unsigned)(-mismatch) & 0xffu));
  const int xm = (int)(((unsigned)match ^ (unsigned)(-mismatch)) & 0xffu);

  const bool top = lane == 0 && k == 0;  // row 0 of the matrix: diagonal 0
  int uh = 0, uf = NEG, dtop = 0;  // H, F above; diagonal
  int snd_h = 0, snd_f = NEG;      // H, F of the lane's bottom row, last column

  // lane l at step s: column s - l, target code tc, the row above (lane 0:
  // the strip above's bottom row, handed in as `in`)
  auto step = [&](int s, int tc, int2 in, auto check) {
    constexpr bool CHECK = decltype(check)::value;
    if (lane == 0) {
      dtop = top ? 0 : uh;
      uh = in.x;
      uf = in.y;
    }
    const int j = s - lane;
    int hu = uh, fu = uf;
    if (CHECK) {
      // the lane ramps in and out without a branch: every lane computes,
      // and one outside 0 <= j < Lt keeps what it had
      const bool active = j >= 0 && j < Lt;
      int H0[R], E0[R], bk0[R], bj0[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        H0[r] = H[r];
        E0[r] = E[r];
        bk0[r] = bk[r];
        bj0[r] = bj[r];
      }
      sw_cells<R, NO_N, PACK, true>(j, tc, hu, fu, dtop, qs, H, E, bk, bj, go, ge, match,
                                    mismatch, nm4, xm, key_scale);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        H[r] = active ? H[r] : H0[r];
        E[r] = active ? E[r] : E0[r];
        bk[r] = active ? bk[r] : bk0[r];
        bj[r] = active ? bj[r] : bj0[r];
      }
      snd_h = active ? hu : snd_h;
      snd_f = active ? fu : snd_f;
      if (has_out && lane == 31 && active) rout[j & (RING - 1)] = make_int2(hu, fu);
    } else {
      sw_cells<R, NO_N, PACK, false>(j, tc, hu, fu, dtop, qs, H, E, bk, bj, go, ge, match,
                                     mismatch, nm4, xm, key_scale);
      snd_h = hu;
      snd_f = fu;
      if (has_out && lane == 31) rout[j & (RING - 1)] = make_int2(hu, fu);
    }
    const int up_h = __shfl_up_sync(FULL, snd_h, 1);
    const int up_f = __shfl_up_sync(FULL, snd_f, 1);
    if (lane != 0) {
      dtop = uh;
      uh = up_h;
      uf = up_f;
    }
  };

  // The handoffs, between chunks of HAND steps: lane 31 publishes the
  // columns it wrote before (< s0 - 31), lane 0 releases the ring slots it
  // read for the chunk before; then the warp waits, if it must, for the
  // slots this chunk writes to be free and the columns it reads written.
  const int n_steps = Lt + 31;
  int read = 0;  // columns lane 0 has read from the ring
  for (int s0 = 0; s0 < n_steps; s0 += HAND) {
    int tcv[HAND];  // the lane's target codes, first: they wait on nothing
#pragma unroll
    for (int i = 0; i < HAND; ++i) tcv[i] = tg[TPAD + s0 + i - lane];
    if (has_out && s0 >= 32 && lane == 31) store_release(ready + k, min(s0 - 31, Lt));
    if (has_in && read > 0 && lane == 0) store_release(taken + k - 1, read);
    const int free_to = has_out ? min(s0 + HAND - 32, Lt - 1) + 1 - RING : 0;
    if (free_to > 0) wait_at_least(taken + k, free_to);
    int2 in[HAND];
#pragma unroll
    for (int i = 0; i < HAND; ++i) in[i] = make_int2(NEG, NEG);
    if (has_in && s0 < Lt) {  // lane 0 takes columns s0 .. s0 + HAND - 1
      read = min(s0 + HAND, Lt);
      wait_at_least(ready + k - 1, read);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < HAND; ++i) {
          if (s0 + i < read) in[i] = rin[(s0 + i) & (RING - 1)];
        }
      }
    }
    if (s0 >= 32 && s0 + HAND <= Lt) {  // every lane inside the matrix
#pragma unroll
      for (int i = 0; i < HAND; ++i) step(s0 + i, tcv[i], in[i], std::false_type());
    } else {
#pragma unroll
      for (int i = 0; i < HAND; ++i) {
        if (s0 + i < n_steps) step(s0 + i, tcv[i], in[i], std::true_type());
      }
    }
  }
  if (has_out && lane == 31) store_release(ready + k, Lt);  // the last columns

  int best_s, best_d, best_i;
  strip_best<R, PACK>(row0, Lq, bk, bj, best_s, best_d, best_i);
  if (lane == 0) {
    slot[3 * k] = best_s;
    slot[3 * k + 1] = best_d;
    slot[3 * k + 2] = best_i;
  }
  __syncthreads();
  if (k != 0) return;
  best_s = 0;
  best_d = best_i = INT_MAX;
  if (lane < S) {
    best_s = slot[3 * lane];
    best_d = slot[3 * lane + 1];
    best_i = slot[3 * lane + 2];
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int s2 = __shfl_down_sync(FULL, best_s, off);
    const int d2 = __shfl_down_sync(FULL, best_d, off);
    const int i2 = __shfl_down_sync(FULL, best_i, off);
    if (better(s2, d2, i2, best_s, best_d, best_i)) {
      best_s = s2;
      best_d = d2;
      best_i = i2;
    }
  }
  if (lane == 0) write_best(b, best_s, best_d, best_i, out_score, out_qend, out_tend);
}

struct Args {
  const int8_t* q;
  const int8_t* t;
  int B, Lq, Lt, match, mismatch, gap_open, gap_extend;
  int* header;
  int4* bnd;
  int32_t *out_score, *out_qend, *out_tend;
};

template <int R, bool NO_N, bool PACK>
cudaError_t launch(const Args& a, int blocks, int threads, cudaStream_t stream) {
  sw_wavefront_kernel<R, NO_N, PACK><<<blocks, threads, 0, stream>>>(
      a.q, a.t, a.B, a.Lq, a.Lt, a.match, a.mismatch, a.gap_open, a.gap_extend, 1 << 16,
      a.header, a.bnd, a.out_score, a.out_qend, a.out_tend);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(const Args& a, bool no_n, bool pack, int blocks, int threads,
                     cudaStream_t stream) {
  if (no_n) {
    return pack ? launch<R, true, true>(a, blocks, threads, stream)
                : launch<R, true, false>(a, blocks, threads, stream);
  }
  return pack ? launch<R, false, true>(a, blocks, threads, stream)
              : launch<R, false, false>(a, blocks, threads, stream);
}

template <int R, bool NO_N, bool PACK>
cudaError_t launch_block(const Args& a, int threads, int smem, cudaStream_t stream) {
  auto kernel = sw_wavefront_block_kernel<R, NO_N, PACK>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.B, threads, smem, stream>>>(a.q, a.t, a.Lq, a.Lt, a.match, a.mismatch,
                                         a.gap_open, a.gap_extend, 1 << 16, a.out_score,
                                         a.out_qend, a.out_tend);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_block_r(const Args& a, bool no_n, bool pack, int threads, int smem,
                           cudaStream_t stream) {
  if (no_n) {
    return pack ? launch_block<R, true, true>(a, threads, smem, stream)
                : launch_block<R, true, false>(a, threads, smem, stream);
  }
  return pack ? launch_block<R, false, true>(a, threads, smem, stream)
              : launch_block<R, false, false>(a, threads, smem, stream);
}

}  // namespace

extern "C" {

// Launches the ticket form on ``stream`` with the plan computed by the
// wrapper (ops/sw_cuda.py::launch_plan): ``rows_per_lane`` R in {4, 8},
// ``blocks`` blocks of ``threads`` threads (a multiple of 32, at
// most 128); ``pack`` keeps a row's best as one key (scores < 2^15, Lt <=
// 2^16) and E as E + ge * j. Device pointers: q [B, Lq] and t [B, Lt]
// int8; outputs [B] int32; when Lq > 32 * R, header [1 + B + 3 * B * S]
// int32 and bnd [B * (S - 1) * Lt] int4, both zeroed, else both null.
// Returns the cudaError_t of the launch (0 on success).
int sw_wavefront_launch(const void* q, const void* t, int B, int Lq, int Lt, int match,
                        int mismatch, int gap_open, int gap_extend, int no_n, int pack,
                        int rows_per_lane, int blocks, int threads, void* header,
                        void* bnd, void* out_score, void* out_qend, void* out_tend,
                        void* stream) {
  if (threads <= 0 || threads > MAX_THREADS || threads % 32 != 0 || blocks <= 0)
    return (int)cudaErrorInvalidConfiguration;
  if (rows_per_lane != 4 && rows_per_lane != 8)
    return (int)cudaErrorInvalidValue;
  const int S = (Lq + 32 * rows_per_lane - 1) / (32 * rows_per_lane);
  if (S > 1 && (header == nullptr || bnd == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{(const int8_t*)q, (const int8_t*)t, B, Lq, Lt, match, mismatch, gap_open,
               gap_extend, (int*)header, (int4*)bnd, (int32_t*)out_score,
               (int32_t*)out_qend, (int32_t*)out_tend};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (rows_per_lane) {
    case 4: return (int)launch_r<4>(a, no_n != 0, pack != 0, blocks, threads, st);
    default: return (int)launch_r<8>(a, no_n != 0, pack != 0, blocks, threads, st);
  }
}

// Launches the block form on ``stream``: B blocks of ``threads`` = 32 S
// threads (S = ceil(Lq / 32 R) <= 32, ``rows_per_lane`` R = 2) and
// ``smem_bytes`` of dynamic shared memory (at least the form's need for S
// and Lt, at most 227 KB); ``pack`` as for the ticket form. Device
// pointers: q [B, Lq] and t [B, Lt] int8; outputs [B] int32; no scratch.
// Returns the cudaError_t of the launch (0 on success).
int sw_block_launch(const void* q, const void* t, int B, int Lq, int Lt, int match,
                    int mismatch, int gap_open, int gap_extend, int no_n, int pack,
                    int rows_per_lane, int threads, int smem_bytes, void* out_score,
                    void* out_qend, void* out_tend, void* stream) {
  if (rows_per_lane != 2) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Lq <= 0 || Lt <= 0) return (int)cudaErrorInvalidValue;
  const int S = (Lq + 32 * rows_per_lane - 1) / (32 * rows_per_lane);
  if (threads != 32 * S || threads > BLOCK_MAX_THREADS)
    return (int)cudaErrorInvalidConfiguration;
  if (smem_bytes < block_smem_bytes(S, Lt) || smem_bytes > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const Args a{(const int8_t*)q, (const int8_t*)t, B, Lq, Lt, match, mismatch, gap_open,
               gap_extend, nullptr, nullptr, (int32_t*)out_score, (int32_t*)out_qend,
               (int32_t*)out_tend};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)launch_block_r<2>(a, no_n != 0, pack != 0, threads, smem_bytes, st);
}

const char* sw_wavefront_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
