// K3: fused restrict + residual, rc[c, j] = sum_{i in agg c} (r - A z)[i, j].
//
// Replaces the Pallas kernel `make_fused_restrict_residual` (inner
// `_kernel`) of src/repro/kernels/vcycle_fused.py, which held the level in
// VMEM and ran `segment_sum(r - L z, agg)`.
//
// What bounds it on the H100: bytes.  The idx/val slabs, r and z are read
// once, the aggregate CSR (perm, agg_ptr) once, and only the
// [n_coarse, k] coarse residual is written; the fine residual never
// reaches memory.
//
// Design: the hierarchy build sorts `agg` once into a CSR of aggregates
// (`perm` lists the fine rows of each aggregate in ascending order,
// `agg_ptr` delimits them).  One thread per (coarse row, column) walks its
// members in that order, computes each member's residual on the fly and
// sums it.  No float atomicAdd, so the sum order — and the result — is the
// same on every run, and it is the order of a sequential segment_sum.
// Aggregates are pairs plus absorbed neighbours, so a thread walks a few
// rows; a hub aggregate serializes in one thread, which a later kernel can
// split across a warp.
//
// Numerics: explicitly rounded __f*_rn with -fmad=false, so the result is
// bitwise equal to the plain PyTorch version (residual by the ordered
// loop, then the ordered member sum).
#include <cuda_runtime.h>

__global__ void restrict_residual_kernel(const int* __restrict__ idx,
                                         const float* __restrict__ val,
                                         const int* __restrict__ perm,
                                         const int* __restrict__ agg_ptr,
                                         const float* __restrict__ r,
                                         const float* __restrict__ z,
                                         float* __restrict__ rc,
                                         int n_coarse, int L, int k) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_coarse * k) return;
  long long c = t / k;
  int j = (int)(t - c * k);
  float acc = 0.0f;
  for (int m = agg_ptr[c]; m < agg_ptr[c + 1]; ++m) {
    long long i = perm[m];
    const int* ir = idx + i * L;
    const float* vr = val + i * L;
    float az = 0.0f;
    for (int l = 0; l < L; ++l) {
      az = __fadd_rn(az, __fmul_rn(vr[l], z[(long long)ir[l] * k + j]));
    }
    acc = __fadd_rn(acc, __fsub_rn(r[i * k + j], az));
  }
  rc[t] = acc;
}

extern "C" int repro_restrict_residual(const void* idx, const void* val,
                                       const void* perm, const void* agg_ptr,
                                       const void* r, const void* z, void* rc,
                                       int n_coarse, int L, int k,
                                       void* stream) {
  long long total = (long long)n_coarse * k;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  restrict_residual_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)val, (const int*)perm,
      (const int*)agg_ptr, (const float*)r, (const float*)z, (float*)rc,
      n_coarse, L, k);
  return (int)cudaGetLastError();
}
