// Batched affine-gap Smith-Waterman as an anti-diagonal wavefront, for
// Hopper (sm_90a).
//
// Replaces breakmer_tpu/ops/sw_pallas.py::_sw_kernel (launched by
// sw_score_pallas). It computes what the plain version computes
// (breakmer_tpu_torch/ops/sw.py::sw_score, itself the scan of
// breakmer_tpu/ops/sw.py): per (query, target) pair the best H cell and
// its end coordinates, tie-broken by (score desc, i + j asc, i asc); a
// best score <= 0 gives (0, -1, -1). A gap of length g costs
// gap_open + gap_extend * g; a code >= 4 (N or pad) scores NEG.
//
// Design. One thread block per pair; the threads stride over the query
// rows i of each anti-diagonal d = 0 .. Lq + Lt - 2, and every cell of a
// diagonal depends only on the two before it, so one __syncthreads per
// diagonal orders the sweep. The DP state is indexed by row i: three H
// diagonals (d, d-1, d-2) in rotation, one E diagonal (a row reads and
// writes only its own E) and two F diagonals (row i reads F[i-1]). Only
// the rows whose cell lies inside the matrix (0 <= d - i < Lt) are
// computed: the cells the recurrence reads from outside it are either
// never written (rows i > d keep their initial 0 / NEG) or are the j == 0
// boundary, which is set explicitly, so the values of every in-matrix
// cell equal the plain version's. Each thread keeps its best cell under a
// strict '>' in (d, i) order, and a block reduction picks the winner on
// the key (score desc, d asc, i asc).
//
// What bounds it on this card: the state is 24 bytes a query row
// (6 int32 arrays) plus the query codes, so it lives in shared memory up
// to Lq of about 9,600 (227 KB a block); past that the wrapper hands the
// kernel a global scratch and the same code runs through L2. Per cell
// the kernel does about 20 integer operations and 6 shared-memory
// accesses, so shared-memory traffic and the per-diagonal barrier bound
// it, not device memory: the inputs are read once (the target through
// the read-only cache). On the TPU the chunked launch form existed only
// because of VMEM; here one kernel covers the direct, no_n and long-target
// forms. no_n (no mid-sequence N) re-encodes pads to never-matching codes
// (query 6, target 7) and drops the N test from the substitution; the
// outputs are bit-identical (see sw_pallas.py's no_n proof).

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int N_STATE = 6;  // H x3, E, F x2

template <bool NO_N>
__global__ void sw_wavefront_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ t,
    int Lq, int Lt, int match, int mismatch, int gap_open, int gap_extend,
    int* scratch,  // written and read back by other threads: no __restrict__
    int32_t* __restrict__ out_score, int32_t* __restrict__ out_qend,
    int32_t* __restrict__ out_tend) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int go = gap_open + gap_extend;
  const int ge = gap_extend;

  // state rows: H(d%3) at 0..2, E at 3, F(d&1) at 4..5, each Lq long
  int* state = scratch ? scratch + (size_t)b * N_STATE * Lq : smem;
  int* E = state + 3 * Lq;
  // query codes always in shared memory, after the state when it is there
  int8_t* sq = reinterpret_cast<int8_t*>(scratch ? smem : smem + N_STATE * Lq);
  const int8_t* tb = t + (size_t)b * Lt;
  const int8_t* qb = q + (size_t)b * Lq;

  for (int i = tid; i < Lq; i += T) {
    state[i] = 0;
    state[Lq + i] = 0;
    state[2 * Lq + i] = 0;
    E[i] = NEG;
    state[4 * Lq + i] = NEG;
    state[5 * Lq + i] = NEG;
    int c = qb[i];
    sq[i] = static_cast<int8_t>(NO_N && c >= 4 ? 6 : c);
  }
  __syncthreads();

  int best_s = 0, best_d = INT_MAX, best_i = INT_MAX;
  const int n_diag = Lq + Lt - 1;
  for (int d = 0; d < n_diag; ++d) {
    int* hc = state + (d % 3) * Lq;               // H of diagonal d
    const int* h1 = state + ((d + 2) % 3) * Lq;   // H of d - 1
    const int* h2 = state + ((d + 1) % 3) * Lq;   // H of d - 2
    int* fc = state + (4 + (d & 1)) * Lq;         // F of d
    const int* f1 = state + (4 + ((d + 1) & 1)) * Lq;  // F of d - 1
    const int lo = max(0, d - Lt + 1);
    const int hi = min(Lq - 1, d);
    for (int i = lo + tid; i <= hi; i += T) {
      const int j = d - i;
      const int qc = sq[i];
      int tc = __ldg(tb + j);
      int sub;
      if (NO_N) {
        if (tc >= 4) tc = 7;
        sub = (qc == tc) ? match : -mismatch;
      } else {
        sub = (qc >= 4 || tc >= 4) ? NEG : ((qc == tc) ? match : -mismatch);
      }
      int e = max(h1[i] - go, E[i] - ge);       // from (i, j-1)
      int hup = NEG, fup = NEG, hdg = 0;
      if (i > 0) {
        hup = h1[i - 1];
        fup = f1[i - 1];
        hdg = h2[i - 1];
      }
      const int f = max(hup - go, fup - ge);    // from (i-1, j)
      if (j == 0) {                             // no j-1 column
        hdg = 0;
        e = NEG;
      }
      const int h = max(max(hdg + sub, 0), max(e, f));
      hc[i] = h;
      E[i] = e;
      fc[i] = f;
      if (h > best_s) {
        best_s = h;
        best_d = d;
        best_i = i;
      }
    }
    __syncthreads();
  }

  // block reduction on (score desc, d asc, i asc)
  __shared__ int red_s[32], red_d[32], red_i[32];
  for (int off = 16; off > 0; off >>= 1) {
    const int s2 = __shfl_down_sync(0xffffffffu, best_s, off);
    const int d2 = __shfl_down_sync(0xffffffffu, best_d, off);
    const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
    if (s2 > best_s || (s2 == best_s && (d2 < best_d || (d2 == best_d && i2 < best_i)))) {
      best_s = s2;
      best_d = d2;
      best_i = i2;
    }
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red_s[warp] = best_s;
    red_d[warp] = best_d;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    const int n_warps = (T + 31) >> 5;
    for (int w = 1; w < n_warps; ++w) {
      const int s2 = red_s[w], d2 = red_d[w], i2 = red_i[w];
      if (s2 > best_s || (s2 == best_s && (d2 < best_d || (d2 == best_d && i2 < best_i)))) {
        best_s = s2;
        best_d = d2;
        best_i = i2;
      }
    }
    const bool none = best_s <= 0;
    out_score[b] = none ? 0 : best_s;
    out_qend[b] = none ? -1 : best_i;
    out_tend[b] = none ? -1 : best_d - best_i;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch needs: the DP state (unless a
// global scratch of B * 6 * Lq int32 is given) plus the query codes.
long long sw_wavefront_smem_bytes(int Lq, int with_scratch) {
  long long q_bytes = ((long long)Lq + 15) / 16 * 16;
  return (with_scratch ? 0 : (long long)N_STATE * Lq * 4) + q_bytes;
}

// Launches one block per pair on ``stream``; returns the cudaError_t of
// the launch (0 on success). Pointers are device pointers: q [B, Lq] and
// t [B, Lt] int8, outputs [B] int32, scratch [B, 6, Lq] int32 or null.
int sw_wavefront_launch(const void* q, const void* t, int B, int Lq, int Lt,
                        int match, int mismatch, int gap_open, int gap_extend,
                        int no_n, int threads, void* scratch,
                        void* out_score, void* out_qend, void* out_tend,
                        void* stream) {
  const long long smem = sw_wavefront_smem_bytes(Lq, scratch != nullptr);
  cudaError_t err;
  auto kern = no_n ? sw_wavefront_kernel<true> : sw_wavefront_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<B, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const int8_t*)t, Lq, Lt, match, mismatch, gap_open,
      gap_extend, (int*)scratch, (int32_t*)out_score, (int32_t*)out_qend,
      (int32_t*)out_tend);
  return (int)cudaGetLastError();
}

const char* sw_wavefront_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
