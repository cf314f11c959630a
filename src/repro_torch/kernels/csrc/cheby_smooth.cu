// K2: the fused Chebyshev smoother, one launch a zero-start sweep's first
// two recurrence steps, and one a warm-start sweep's first step with the
// V-cycle's prolongation folded in.
//
// Replaces the Pallas kernel `make_fused_chebyshev` (inner `_kernel`) of
// src/repro/kernels/vcycle_fused.py:160, which ran the whole degree-d
// recurrence `cheby_recurrence` in one call with the level held in VMEM.
// On the H100 the top level of the main path is about 59 MB of slabs
// against 227 KB of shared memory a block and 50 MB of L2, so the level
// crosses device memory on every pass.
//
// What bounds it on the H100: bytes.  At level 0 (n = 2^20, L = 7, k = 8)
// a pass over the idx/val slabs is 59 MB and a k-wide vector 34 MB, while
// the arithmetic is a few operations a stored entry.  The design cuts the
// passes and the vectors that cross memory:
//
//   * The zero-start sweep (the V-cycle's pre-smooth) is one launch.  From
//     a zero start the first step has no matvec: its iterate at row j is
//     z1[j] = (inv_d[j] * r[j]) / theta.  Each row recomputes z1 of every
//     neighbour it reads, in the same rounded operations, so the second
//     step's matvec runs in the same pass.  The launch reads the slabs,
//     inv_d and r once and writes only z (and p when later steps follow):
//     about 130 MB at level 0, where two step launches moved 336 MB.
//
//   * The warm-start sweep (the post-smooth) folds the prolongation into
//     its first step: every neighbour's iterate is read as
//     z[j] + zc[agg[j]], one rounded add, the bits the separate gather and
//     add gave.  The gather and the add (a 34 MB write and 101 MB of
//     traffic at level 0) are gone.
//
//   * The warm-start sweep cannot be one pass: its second step needs z1 of
//     every neighbour, and z1[j] needs the iterate of j's neighbours (a
//     two-hop matvec).  So p1 and z1 go through device memory, which at
//     level 0 they must (they do not fit on chip), and the second step is
//     the later-step kernel of cheby_step.cu, one launch after this one.
//     A cooperative launch with a grid sync between the steps saved 0.3-0.8
//     us a sweep on levels of at most 8,432 rows but moved neither the
//     solve's wall time nor its device time on an H100, so it is not kept.
//     Further steps (degree > 2) run the later-step kernel too.
//
// Numerics: the operation order of `cheby_recurrence` is kept, the scalars
// c1 = rho_k * rho_prev and c2 = 2 * rho_k / delta are computed in double
// on the host and applied as f32, and every operation is an explicitly
// rounded __f*_rn (the library is built with -fmad=false), so each launch
// is bitwise equal to its plain PyTorch version (kernels/ref.py).
// One thread an (row, column) element, as in cheby_step.cu.
#include <cuda_runtime.h>

constexpr int THREADS = 256;

// the first step's iterate at row j from a zero start
__device__ __forceinline__ float zero_iterate(const float* __restrict__ inv_d,
                                              const float* __restrict__ r,
                                              long long j, int k, int c,
                                              float theta) {
  return __fdiv_rn(__fmul_rn(inv_d[j], r[j * k + c]), theta);
}

// the warm start at row j: z[j] + zc[agg[j]], or z[j] without zc
__device__ __forceinline__ float warm_iterate(const float* __restrict__ z,
                                              const float* __restrict__ zc,
                                              const int* __restrict__ agg,
                                              long long j, int k, int c) {
  float v = z[j * k + c];
  return zc == nullptr ? v : __fadd_rn(v, zc[(long long)agg[j] * k + c]);
}

// the pre-smooth: steps 1 and 2 from a zero start in one pass
__global__ void __launch_bounds__(THREADS) cheby_smooth_zero_kernel(
    const int* __restrict__ idx, const float* __restrict__ val,
    const float* __restrict__ inv_d, const float* __restrict__ r,
    float* __restrict__ p, float* __restrict__ z_out, int n, int L, int k,
    float theta, float c1, float c2) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * k) return;
  long long i = t / k;
  int c = (int)(t - i * k);
  const int* ir = idx + i * L;
  const float* vr = val + i * L;
  float az = 0.0f;
  for (int l = 0; l < L; ++l) {
    az = __fadd_rn(az, __fmul_rn(vr[l], zero_iterate(inv_d, r, ir[l], k, c,
                                                     theta)));
  }
  float dres = __fmul_rn(inv_d[i], __fsub_rn(r[t], az));
  float p1 = zero_iterate(inv_d, r, i, k, c, theta);
  float p2 = __fadd_rn(__fmul_rn(c1, p1), __fmul_rn(c2, dres));
  if (p != nullptr) p[t] = p2;
  z_out[t] = __fadd_rn(p1, p2);
}

// the post-smooth's first launch: step 1 from z + zc[agg], writing p1 and z1
__global__ void __launch_bounds__(THREADS) cheby_prolong_step_kernel(
    const int* __restrict__ idx, const float* __restrict__ val,
    const float* __restrict__ inv_d, const float* __restrict__ r,
    const float* __restrict__ z, const float* __restrict__ zc,
    const int* __restrict__ agg, float* __restrict__ p,
    float* __restrict__ z1, int n, int L, int k, float theta) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * k) return;
  long long i = t / k;
  int c = (int)(t - i * k);
  const int* ir = idx + i * L;
  const float* vr = val + i * L;
  float az = 0.0f;
  for (int l = 0; l < L; ++l) {
    az = __fadd_rn(az, __fmul_rn(vr[l], warm_iterate(z, zc, agg, ir[l], k,
                                                     c)));
  }
  float p1 = __fdiv_rn(__fmul_rn(inv_d[i], __fsub_rn(r[t], az)), theta);
  p[t] = p1;
  z1[t] = __fadd_rn(warm_iterate(z, zc, agg, i, k, c), p1);
}

extern "C" int repro_cheby_smooth_zero(const void* idx, const void* val,
                                       const void* inv_d, const void* r,
                                       void* p, void* z_out, int n, int L,
                                       int k, float theta, float c1,
                                       float c2, void* stream) {
  long long total = (long long)n * k;
  if (total == 0) return 0;
  const int threads = THREADS;
  long long blocks = (total + threads - 1) / threads;
  cheby_smooth_zero_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)val, (const float*)inv_d,
      (const float*)r, (float*)p, (float*)z_out, n, L, k, theta, c1, c2);
  return (int)cudaGetLastError();
}

extern "C" int repro_cheby_prolong_step(const void* idx, const void* val,
                                        const void* inv_d, const void* r,
                                        const void* z, const void* zc,
                                        const void* agg, void* p, void* z1,
                                        int n, int L, int k, float theta,
                                        void* stream) {
  long long total = (long long)n * k;
  if (total == 0) return 0;
  const int threads = THREADS;
  long long blocks = (total + threads - 1) / threads;
  cheby_prolong_step_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)val, (const float*)inv_d,
      (const float*)r, (const float*)z, (const float*)zc, (const int*)agg,
      (float*)p, (float*)z1, n, L, k, theta);
  return (int)cudaGetLastError();
}
