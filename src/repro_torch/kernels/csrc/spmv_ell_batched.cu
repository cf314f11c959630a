// K1: batched-RHS ELL spmv, y[i, j] = sum_l val[i, l] * x[idx[i, l], j].
//
// Replaces the Pallas kernel `spmv_ell_batched` (body `_spmv_batched_kernel`)
// of src/repro/kernels/vcycle_fused.py.
//
// What bounds it on the H100: bytes.  Each output element costs L
// multiply-adds against 8 bytes of idx+val per slab entry and a gathered x
// element, so the kernel is far below the card's ridge point; the least
// time is the idx/val slabs read once, x read once and y written once at
// the HBM rate.  On the main path (n = 2^20, L = 7, k = 8) that is
// 58.7 MB of slabs plus 2 x 33.5 MB of vectors.
//
// Design: one thread per (row, column), with the k columns of a row on
// consecutive threads.  The k threads of a row read the same idx/val entry
// (one broadcast transaction) and gather k consecutive floats of x (one
// 32-byte sector for k = 8), so both streams stay coalesced.  The TPU
// kernel held x in VMEM and padded rows to its tile; here x streams
// through L2, rows past n do not exist (masked by the bound check), and
// x may have more rows than the slab (nx >= n).
//
// Numerics: the sum runs over l = 0..L-1 in order with __fmul_rn /
// __fadd_rn (and the library is built with -fmad=false), so no FMA
// contraction happens and the result is bitwise equal to the plain
// PyTorch loop `acc = acc + val[:, l, None] * x[idx[:, l]]`.
#include <cuda_runtime.h>

__global__ void spmv_ell_batched_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ val,
                                        const float* __restrict__ x,
                                        float* __restrict__ y,
                                        int n, int L, int k) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * k) return;
  long long i = t / k;
  int j = (int)(t - i * k);
  const int* ir = idx + i * L;
  const float* vr = val + i * L;
  float acc = 0.0f;
  for (int l = 0; l < L; ++l) {
    acc = __fadd_rn(acc, __fmul_rn(vr[l], x[(long long)ir[l] * k + j]));
  }
  y[t] = acc;
}

extern "C" int repro_spmv_ell_batched(const void* idx, const void* val,
                                      const void* x, void* y, int n, int L,
                                      int k, void* stream) {
  long long total = (long long)n * k;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  spmv_ell_batched_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)val, (const float*)x, (float*)y, n, L,
      k);
  return (int)cudaGetLastError();
}
