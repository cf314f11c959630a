// Variants of the one-row-a-thread listing design of K4 (before its grid
// became branch-free), each stopping after one more step, so their device
// times show where a launch's time goes.  Built and timed by
// tools/k4_probe.py; not part of the port.
//
//   0  write the zero output only
//   1  + read each row's subtask id
//   2  + the block's range of subtask ids (warp min/max, shared atomics)
//   3  + list the candidates of that range (cbeta/cseg loads)
//   4  + stage their signatures and walk them, the (c1)^2 grid behind a
//        runtime a + b <= lim branch: the full kernel
//   5  4 without the grid (a row's first candidate of its subtask marks it)
//   6  4 with the grid reading the candidates' signatures from global
//      memory instead of staging them
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128, kThreads = 256, C1 = 9;

template <int V>
__global__ void probe(const int* csu, const int* csv, const int* cbeta,
                      const int* cseg, const int* esu, const int* esv,
                      const int* eseg, uint8_t* out, int K, int m) {
  __shared__ int s_su[kTile * C1], s_sv[kTile * C1], s_beta[kTile],
      s_seg[kTile], s_k[kTile];
  __shared__ int s_lo, s_hi, s_n;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < m;
  if (V == 0) {
    if (live) out[j] = 0;
    return;
  }
  const int seg = live ? eseg[j] : 0;
  if (V == 1) {
    if (live) out[j] = seg == 12345;
    return;
  }
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = INT_MIN;
  }
  __syncthreads();
  const int lo = __reduce_min_sync(0xffffffffu, live ? seg : INT_MAX);
  const int hi = __reduce_max_sync(0xffffffffu, live ? seg : INT_MIN);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  if (V == 2) {
    if (live) out[j] = s_lo == 12345 || s_hi == 12345;
    return;
  }
  bool kill = false;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int nk = min(kTile, K - k0);
    __syncthreads();
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    if (threadIdx.x < nk) {
      const int k = k0 + threadIdx.x;
      const int beta = cbeta[k], sg = cseg[k];
      if (beta >= 0 && sg >= s_lo && sg <= s_hi) {
        const int i = atomicAdd(&s_n, 1);
        s_beta[i] = beta;
        s_seg[i] = sg;
        s_k[i] = k;
      }
    }
    __syncthreads();
    const int n = s_n;
    if (V == 3) {
      kill = n == 12345;
      continue;
    }
    if (V != 6)
      for (int t = threadIdx.x; t < n * C1; t += blockDim.x) {
        const long long src = (long long)s_k[t / C1] * C1 + t % C1;
        s_su[t] = csu[src];
        s_sv[t] = csv[src];
      }
    __syncthreads();
    if (!live || kill) continue;
    int eu[C1], ev[C1];
    bool loaded = false;
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
      if (V == 5) {
        kill = eu[0] != 12345 || ev[0] != 54321;
        break;
      }
      const int beta = s_beta[i];
      const int lim = beta < C1 - 1 ? beta : C1 - 1;
      bool uu = false, vv = false, uv = false, vu = false;
#pragma unroll
      for (int a = 0; a < C1; ++a) {
        const int cu = V == 6 ? csu[s_k[i] * C1 + a] : s_su[i * C1 + a];
        const int cv = V == 6 ? csv[s_k[i] * C1 + a] : s_sv[i * C1 + a];
#pragma unroll
        for (int b = 0; b < C1; ++b)
          if (a + b <= lim) {
            uu |= cu == eu[b];
            vv |= cv == ev[b];
            uv |= cu == ev[b];
            vu |= cv == eu[b];
          }
      }
      if ((uu && vv) || (uv && vu)) {
        kill = true;
        break;
      }
    }
  }
  if (live) out[j] = kill;
}

}  // namespace

extern "C" int k4_probe(int v, const void* csu, const void* csv,
                        const void* cbeta, const void* cseg, const void* esu,
                        const void* esv, const void* eseg, void* out, int K,
                        int m, void* stream) {
  const unsigned blocks = (m + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_PROBE(V)                                                   \
  probe<V><<<blocks, kThreads, 0, st>>>(                                 \
      (const int*)csu, (const int*)csv, (const int*)cbeta,               \
      (const int*)cseg, (const int*)esu, (const int*)esv,                \
      (const int*)eseg, (uint8_t*)out, K, m)
  switch (v) {
    case 0: REPRO_PROBE(0); break;
    case 1: REPRO_PROBE(1); break;
    case 2: REPRO_PROBE(2); break;
    case 3: REPRO_PROBE(3); break;
    case 4: REPRO_PROBE(4); break;
    case 5: REPRO_PROBE(5); break;
    default: REPRO_PROBE(6); break;
  }
#undef REPRO_PROBE
  return (int)cudaGetLastError();
}
