// K2's later-step kernel: one step of the Chebyshev recurrence with its
// matvec.  The sweeps of cheby_smooth.cu (one launch the zero-start
// sweep's first two steps; the warm-start sweep's first step with the
// prolongation folded in) hand their p and z to it for the steps they do
// not run: the warm-start sweep's second step, and every step past the
// second.  From a zero start it also runs the first
// step alone (no matvec), for a degree-1 sweep.
//
// Replaces, with cheby_smooth.cu, the Pallas kernel `make_fused_chebyshev`
// (inner `_kernel`) of src/repro/kernels/vcycle_fused.py, which ran the
// whole degree-d recurrence `cheby_recurrence` in one call with the level
// held in VMEM.
//
// Per (row i, column j):
//     res = r - A z_prev                    (or r when starting from zero)
//     p   = (inv_d * res) / theta           (first step)
//     p   = c1 * p + c2 * (inv_d * res)     (later steps)
//     z   = z_prev + p                      (or p when starting from zero)
// Other rows read z_prev, so z_out must be another buffer; p is read and
// written only by its own thread and is updated in place.
//
// What bounds it on the H100: bytes.  A step with a matvec reads the
// idx/val slabs, inv_d, r, z_prev and p once and writes p and z once.
//
// Numerics: the operation order of `cheby_recurrence` is kept, the scalars
// c1 = rho_k * rho_prev and c2 = 2 * rho_k / delta are computed in double
// on the host and applied as f32, and every operation is an explicitly
// rounded __f*_rn (the library is built with -fmad=false), so a step is
// bitwise equal to the same step in plain PyTorch.
#include <cuda_runtime.h>

__global__ void cheby_step_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ val,
                                  const float* __restrict__ inv_d,
                                  const float* __restrict__ r,
                                  const float* __restrict__ z_prev,
                                  float* p, float* __restrict__ z_out,
                                  int n, int L, int k, int first,
                                  float theta, float c1, float c2) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * k) return;
  long long i = t / k;
  int j = (int)(t - i * k);
  float res = r[t];
  if (z_prev != nullptr) {
    const int* ir = idx + i * L;
    const float* vr = val + i * L;
    float az = 0.0f;
    for (int l = 0; l < L; ++l) {
      az = __fadd_rn(az, __fmul_rn(vr[l], z_prev[(long long)ir[l] * k + j]));
    }
    res = __fsub_rn(res, az);
  }
  float dres = __fmul_rn(inv_d[i], res);
  float pn;
  if (first) {
    pn = __fdiv_rn(dres, theta);
  } else {
    pn = __fadd_rn(__fmul_rn(c1, p[t]), __fmul_rn(c2, dres));
  }
  p[t] = pn;
  z_out[t] = (z_prev != nullptr) ? __fadd_rn(z_prev[t], pn) : pn;
}

extern "C" int repro_cheby_step(const void* idx, const void* val,
                                const void* inv_d, const void* r,
                                const void* z_prev, void* p, void* z_out,
                                int n, int L, int k, int first, float theta,
                                float c1, float c2, void* stream) {
  long long total = (long long)n * k;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  cheby_step_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)val, (const float*)inv_d,
      (const float*)r, (const float*)z_prev, (float*)p, (float*)z_out, n, L,
      k, first, theta, c1, c2);
  return (int)cudaGetLastError();
}
