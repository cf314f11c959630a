// K4: strict-similarity marking pass of the recovery rounds,
// kill[j] = exists k: cseg[k] == eseg[j] and candidate k marks edge j,
// where k marks j iff (uu && vv) || (uv && vu) and, e.g.,
// uu = exists (a, b), a + b <= min(cbeta[k], c1 - 1): csu[k, a] == esu[j, b].
//
// Replaces the Pallas kernel `similarity_mark` (body `_sim_kernel`) of
// src/repro/kernels/similarity.py, including its static skip of the
// pairs with a + b > c1 - 1.
//
// What bounds it on the H100: bytes.  Every edge row reads its subtask id
// (4 bytes) and writes one byte; only a row that some recovered candidate
// (cbeta >= 0) of its own subtask could mark needs its two signatures
// (2 * c1 * 4 bytes), and in the round engine those are few.  The K <= 128
// candidates are a few KB.
//
// Design: the TPU kernel computed the whole dense K x tile block, because
// its vector unit wants dense work.  Here one thread owns one edge row.
// A block first finds the ranges of its rows' subtask ids, one over the
// ids >= 0 and one over the negative ids of padding rows (a warp min/max,
// then shared atomics), then lists, 128 candidates at a time, those with
// cbeta >= 0 whose subtask lies in either range, and stages only their
// signatures in shared memory (at most 16 KB at c1 = 16).  In the round
// engine the rows are ordered by subtask, so almost every block lists no
// candidate.  The list's order depends on the atomics; the output is
// boolean, so the result is bit-identical to the plain version whatever
// the order.  Each thread walks the list, skips a candidate of another
// subtask, and at the first one of its own loads its row's signatures into
// registers (C1 is a template parameter, so the unrolled loops index them
// statically): a row no candidate can mark never reads them.  The grid of
// a candidate and a row tests only the pairs a + b <= c1 - 1 (the static
// skip), without branches: each of the four relations gathers its matches
// as bits over the diagonal a + b, and one mask test keeps the diagonals
// a + b <= cbeta.  The lanes of a warp run their grids one after another
// when their rows meet different candidates, as they do in the block that
// holds the candidates' own rows; that block sets the kernel's time, and a
// cheap grid keeps it short.  The walk stops at the first mark.  Rows need
// no padding: a thread past m joins the block's staging and writes
// nothing.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;     // candidates listed per pass
constexpr int kThreads = 256;  // edge rows per block
constexpr int kMaxC1 = 16;
static_assert(kThreads >= kTile, "one thread tests one candidate of a tile");

template <int C1>
__global__ void similarity_mark_kernel(const int* __restrict__ csu,
                                       const int* __restrict__ csv,
                                       const int* __restrict__ cbeta,
                                       const int* __restrict__ cseg,
                                       const int* __restrict__ esu,
                                       const int* __restrict__ esv,
                                       const int* __restrict__ eseg,
                                       uint8_t* __restrict__ out, int K,
                                       int m) {
  __shared__ int s_su[kTile * C1];  // signatures of the listed candidates
  __shared__ int s_sv[kTile * C1];
  __shared__ int s_beta[kTile];
  __shared__ int s_seg[kTile];
  __shared__ int s_k[kTile];        // their candidate indices
  __shared__ int s_lo, s_hi, s_nlo, s_nhi, s_n;

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < m;
  const int seg = live ? eseg[j] : 0;
  if (threadIdx.x == 0) {
    s_lo = s_nlo = INT_MAX;
    s_hi = s_nhi = INT_MIN;
  }
  __syncthreads();
  {
    const bool pos = live && seg >= 0, neg = live && seg < 0;
    const int lo = __reduce_min_sync(0xffffffffu, pos ? seg : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, pos ? seg : INT_MIN);
    const int nlo = __reduce_min_sync(0xffffffffu, neg ? seg : INT_MAX);
    const int nhi = __reduce_max_sync(0xffffffffu, neg ? seg : INT_MIN);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
      atomicMin(&s_nlo, nlo);
      atomicMax(&s_nhi, nhi);
    }
  }
  int eu[C1], ev[C1];
  bool loaded = false;  // eu/ev hold the row's signatures
  bool kill = false;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int nk = min(kTile, K - k0);
    __syncthreads();  // the ranges are final; the previous tile is not read
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    if (threadIdx.x < nk) {
      const int k = k0 + threadIdx.x;
      const int beta = cbeta[k], sg = cseg[k];
      if (beta >= 0 && ((sg >= s_lo && sg <= s_hi) ||
                        (sg >= s_nlo && sg <= s_nhi))) {
        const int i = atomicAdd(&s_n, 1);
        s_beta[i] = beta;
        s_seg[i] = sg;
        s_k[i] = k;
      }
    }
    __syncthreads();
    const int n = s_n;
    if (n == 0) continue;  // the same for the whole block
    for (int t = threadIdx.x; t < n * C1; t += blockDim.x) {
      const long long src = (long long)s_k[t / C1] * C1 + t % C1;
      s_su[t] = csu[src];
      s_sv[t] = csv[src];
    }
    __syncthreads();
    if (!live || kill) continue;
    for (int i = 0; i < n; ++i) {
      if (s_seg[i] != seg) continue;
      if (!loaded) {
#pragma unroll
        for (int b = 0; b < C1; ++b) {
          eu[b] = esu[j * C1 + b];
          ev[b] = esv[j * C1 + b];
        }
        loaded = true;
      }
      const int beta = s_beta[i];
      const int lim = beta < C1 - 1 ? beta : C1 - 1;
      const int* su = s_su + i * C1;
      const int* sv = s_sv + i * C1;
      // bit d of a mask: some pair with a + b == d matches
      unsigned muu = 0, mvv = 0, muv = 0, mvu = 0;
#pragma unroll
      for (int a = 0; a < C1; ++a) {
        const int cu = su[a], cv = sv[a];
#pragma unroll
        for (int b = 0; a + b < C1; ++b) {
          const unsigned bit = 1u << (a + b);
          muu |= cu == eu[b] ? bit : 0u;
          mvv |= cv == ev[b] ? bit : 0u;
          muv |= cu == ev[b] ? bit : 0u;
          mvu |= cv == eu[b] ? bit : 0u;
        }
      }
      const unsigned within = (2u << lim) - 1u;  // diagonals a + b <= lim
      if (((muu & within) && (mvv & within)) ||
          ((muv & within) && (mvu & within))) {
        kill = true;
        break;
      }
    }
  }
  if (live) out[j] = kill ? 1 : 0;
}

template <int C1>
int launch(const void* csu, const void* csv, const void* cbeta,
           const void* cseg, const void* esu, const void* esv,
           const void* eseg, void* out, int K, int m, cudaStream_t stream) {
  const long long blocks = ((long long)m + kThreads - 1) / kThreads;
  similarity_mark_kernel<C1><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int*)csu, (const int*)csv, (const int*)cbeta, (const int*)cseg,
      (const int*)esu, (const int*)esv, (const int*)eseg, (uint8_t*)out, K,
      m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_similarity_mark(const void* csu, const void* csv,
                                     const void* cbeta, const void* cseg,
                                     const void* esu, const void* esv,
                                     const void* eseg, void* out, int K,
                                     int m, int c1, void* stream) {
  if (m == 0) return 0;
  if (c1 < 1 || c1 > kMaxC1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c1) {
#define REPRO_SIM_CASE(C) \
  case C:                 \
    return launch<C>(csu, csv, cbeta, cseg, esu, esv, eseg, out, K, m, s);
    REPRO_SIM_CASE(1) REPRO_SIM_CASE(2) REPRO_SIM_CASE(3) REPRO_SIM_CASE(4)
    REPRO_SIM_CASE(5) REPRO_SIM_CASE(6) REPRO_SIM_CASE(7) REPRO_SIM_CASE(8)
    REPRO_SIM_CASE(9) REPRO_SIM_CASE(10) REPRO_SIM_CASE(11)
    REPRO_SIM_CASE(12) REPRO_SIM_CASE(13) REPRO_SIM_CASE(14)
    REPRO_SIM_CASE(15) REPRO_SIM_CASE(16)
#undef REPRO_SIM_CASE
  }
  return (int)cudaErrorInvalidValue;
}
