// Timing aids for K4 (kernels/csrc/similarity_mark.cu), built and run by
// tools/k4_probe.py; not part of the port.
//
// k4_probe_previous: the kernel the shipped one replaced (one edge row a
// thread; each block lists the recovered candidates of its rows' subtask
// ranges, stages their signatures and every lane walks the list), kept
// verbatim so that one call times it beside the shipped kernel.
//
// k4_probe_stream: the shipped kernel's row stream, each variant stopping
// after one more step (16 rows a thread, 4096 a block, as shipped):
//   0  write the zero output only (one 16-byte store a thread)
//   1  + read the rows' subtask ids (four 16-byte loads a thread)
//   2  + the block's ranges of subtask ids (warp min/max, one barrier)
//   3  + test the candidates against them (__syncthreads_count): the whole
//      cost of a block that lists no candidate
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace previous {

constexpr int kTile = 128;
constexpr int kThreads = 256;

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

}  // namespace previous

namespace {

constexpr int kThreads = 256, kRowsPerThread = 16, kRows = 4096, kWarps = 8;

template <int V>
__global__ void __launch_bounds__(kThreads, 4)
    stream_probe(const int* __restrict__ cbeta, const int* __restrict__ cseg,
                 const int* __restrict__ eseg, uint8_t* __restrict__ out,
                 int K, int m) {
  __shared__ int4 s_range[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = (long long)blockIdx.x * kRows + t * kRowsPerThread;
  if (base >= m) return;  // whole warps of rows only: m % 512 == 0
  uint4 w = make_uint4(0, 0, 0, 0);
  if (V >= 1) {
    int seg[kRowsPerThread];
    const int4* p = reinterpret_cast<const int4*>(eseg + base);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = __ldg(p + q);
      seg[4 * q] = v.x;
      seg[4 * q + 1] = v.y;
      seg[4 * q + 2] = v.z;
      seg[4 * q + 3] = v.w;
    }
    int lo = INT_MAX, hi = INT_MIN, nlo = INT_MAX, nhi = INT_MIN;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int s = seg[i];
      lo = s >= 0 ? min(lo, s) : lo;
      hi = s >= 0 ? max(hi, s) : hi;
      nlo = s < 0 ? min(nlo, s) : nlo;
      nhi = s < 0 ? max(nhi, s) : nhi;
    }
    if (V == 1) w.x = lo == 12345 || nhi == 12345;
    if (V >= 2) {
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      nlo = __reduce_min_sync(0xffffffffu, nlo);
      nhi = __reduce_max_sync(0xffffffffu, nhi);
      if (lane == 0) s_range[warp] = make_int4(lo, hi, nlo, nhi);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        const int4 r = s_range[q];
        lo = min(lo, r.x);
        hi = max(hi, r.y);
        nlo = min(nlo, r.z);
        nhi = max(nhi, r.w);
      }
      if (V == 2) w.x = lo == 12345 || nhi == 12345;
    }
    if (V >= 3) {
      int n = 0;
      for (int k0 = 0; k0 < K; k0 += kThreads) {
        bool listed = false;
        if (t < K - k0) {
          const int beta = __ldg(cbeta + k0 + t), sg = __ldg(cseg + k0 + t);
          listed = beta >= 0 && ((sg >= lo && sg <= hi) ||
                                 (sg >= nlo && sg <= nhi));
        }
        n += __syncthreads_count(listed);
      }
      w.x = n == 12345;
    }
  }
  *reinterpret_cast<uint4*>(out + base) = w;
}

}  // namespace

extern "C" int k4_probe_previous(const void* csu, const void* csv,
                             const void* cbeta, const void* cseg,
                             const void* esu, const void* esv,
                             const void* eseg, void* out, int K, int m,
                             void* stream) {
  const unsigned blocks = (m + previous::kThreads - 1) / previous::kThreads;
  previous::similarity_mark_kernel<9><<<blocks, previous::kThreads, 0,
                                    (cudaStream_t)stream>>>(
      (const int*)csu, (const int*)csv, (const int*)cbeta, (const int*)cseg,
      (const int*)esu, (const int*)esv, (const int*)eseg, (uint8_t*)out, K,
      m);
  return (int)cudaGetLastError();
}

extern "C" int k4_probe_stream(int v, const void* cbeta, const void* cseg,
                               const void* eseg, void* out, int K, int m,
                               void* stream) {
  const unsigned blocks = (m + kRows - 1) / kRows;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_PROBE(V)                                                    \
  stream_probe<V><<<blocks, kThreads, 0, st>>>(                           \
      (const int*)cbeta, (const int*)cseg, (const int*)eseg,              \
      (uint8_t*)out, K, m)
  switch (v) {
    case 0: REPRO_PROBE(0); break;
    case 1: REPRO_PROBE(1); break;
    case 2: REPRO_PROBE(2); break;
    default: REPRO_PROBE(3); break;
  }
#undef REPRO_PROBE
  return (int)cudaGetLastError();
}
