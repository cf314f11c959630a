// K5: single-column ELL spmv, y[i] = sum_l val[i, l] * x[idx[i, l]].
//
// Replaces the Pallas kernel `spmv_ell` (body `_spmv_kernel`) of
// src/repro/kernels/spmv_ell.py, which backs `matvec_impl="kernel"`: the
// solver runs it once per right-hand-side column.
//
// What bounds it on the H100: bytes.  Each row reads L (idx, val) pairs,
// gathers L entries of x and writes one float: 2 L flops against 8 L + 8
// bytes.  On the main path's top level (n = 2^20, L = 7) the slabs, x and
// y come to 67.1 MB.
//
// Design: one thread per row.  The TPU kernel held x in VMEM and padded
// rows to its tile; here x streams through L2 and rows past n do not
// exist (bound check).  x may have more rows than the slab.
//
// Numerics: the sum runs over l = 0..L-1 in order with __fmul_rn /
// __fadd_rn (and the library is built with -fmad=false), so the result is
// bitwise equal to the plain PyTorch loop and to one column of K1.
#include <cuda_runtime.h>

__global__ void spmv_ell_kernel(const int* __restrict__ idx,
                                const float* __restrict__ val,
                                const float* __restrict__ x,
                                float* __restrict__ y, int n, int L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* ir = idx + i * L;
  const float* vr = val + i * L;
  float acc = 0.0f;
  for (int l = 0; l < L; ++l) {
    acc = __fadd_rn(acc, __fmul_rn(vr[l], x[ir[l]]));
  }
  y[i] = acc;
}

extern "C" int repro_spmv_ell(const void* idx, const void* val,
                              const void* x, void* y, int n, int L,
                              void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)n + threads - 1) / threads;
  spmv_ell_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)val, (const float*)x, (float*)y, n, L);
  return (int)cudaGetLastError();
}
