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
// `agg_ptr` delimits them), and the fused V-cycle's set-up copies each
// level's slabs into that order once (`idx_agg`/`val_agg`: row m holds
// slab row perm[m], padded to LP = 4 * ceil(L / 4) columns), so a member's
// slab row is one run of 16-byte loads next to its aggregate neighbours'
// instead of a scattered 4L-byte row behind a load of perm[m].  One thread
// a (coarse row, 4 columns) walks its members in order, two members' loads
// in flight at once (aggregates hold 2.6 rows on average), with L a
// template parameter so a row's L gathers of z (float4 each) are issued
// together.  No float atomicAdd, so the sum order, and the result, is the
// same on every run: the order of a sequential segment_sum.  A hub
// aggregate serializes in its threads.
//
// Where k is not a multiple of 4, L is above 16, or no aggregate-order
// copy is given, one thread a (coarse row, column) walks the members and
// reads the slabs through perm with a runtime L.
//
// Numerics: explicitly rounded __f*_rn with -fmad=false, so the result is
// bitwise equal to the plain PyTorch version (each member's A z by the
// ordered loop over l, then the ordered member sum, from 0.0f).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 16;   // template instances L = 1..kMaxL

__global__ void restrict_residual_any(const int* __restrict__ idx,
                                      const float* __restrict__ val,
                                      const int* __restrict__ perm,
                                      const int* __restrict__ agg_ptr,
                                      const float* __restrict__ r,
                                      const float* __restrict__ z,
                                      float* __restrict__ rc, int n_coarse,
                                      int L, int k) {
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

__device__ __forceinline__ float4 madd(float4 a, float v, float4 z) {
  a.x = __fadd_rn(a.x, __fmul_rn(v, z.x));
  a.y = __fadd_rn(a.y, __fmul_rn(v, z.y));
  a.z = __fadd_rn(a.z, __fmul_rn(v, z.z));
  a.w = __fadd_rn(a.w, __fmul_rn(v, z.w));
  return a;
}

__device__ __forceinline__ float4 add_resid(float4 a, float4 r, float4 az) {
  a.x = __fadd_rn(a.x, __fsub_rn(r.x, az.x));
  a.y = __fadd_rn(a.y, __fsub_rn(r.y, az.y));
  a.z = __fadd_rn(a.z, __fsub_rn(r.z, az.z));
  a.w = __fadd_rn(a.w, __fsub_rn(r.w, az.w));
  return a;
}

// (A z)[perm[m], 4g .. 4g + 3], from member m's row of the aggregate-order
// copy
template <int L, int LP>
__device__ __forceinline__ float4 member_az(const int4* __restrict__ idx_agg,
                                            const float4* __restrict__ val_agg,
                                            long long m,
                                            const float4* __restrict__ z,
                                            int G, int g) {
  int ir[LP];
  float vr[LP];
#pragma unroll
  for (int l = 0; l < LP; l += 4) {
    const int4 iv = idx_agg[m * (LP / 4) + l / 4];
    const float4 vv = val_agg[m * (LP / 4) + l / 4];
    ir[l] = iv.x, ir[l + 1] = iv.y, ir[l + 2] = iv.z, ir[l + 3] = iv.w;
    vr[l] = vv.x, vr[l + 1] = vv.y, vr[l + 2] = vv.z, vr[l + 3] = vv.w;
  }
  float4 zz[L];
#pragma unroll
  for (int l = 0; l < L; ++l) zz[l] = z[(long long)ir[l] * G + g];
  float4 az = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int l = 0; l < L; ++l) az = madd(az, vr[l], zz[l]);
  return az;
}

// one thread a (coarse row c, columns 4g .. 4g + 3); G = k / 4
template <int L>
__global__ void restrict_residual_vec(const int4* __restrict__ idx_agg,
                                      const float4* __restrict__ val_agg,
                                      const int* __restrict__ perm,
                                      const int* __restrict__ agg_ptr,
                                      const float4* __restrict__ r,
                                      const float4* __restrict__ z,
                                      float4* __restrict__ rc, int n_coarse,
                                      int G) {
  constexpr int LP = (L + 3) / 4 * 4;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_coarse * G) return;
  long long c = t / G;
  int g = (int)(t - c * G);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int end = agg_ptr[c + 1];
  int m = agg_ptr[c];
  for (; m + 1 < end; m += 2) {  // two members in flight, summed in order
    const float4 r0 = r[(long long)perm[m] * G + g];
    const float4 r1 = r[(long long)perm[m + 1] * G + g];
    const float4 a0 = member_az<L, LP>(idx_agg, val_agg, m, z, G, g);
    const float4 a1 = member_az<L, LP>(idx_agg, val_agg, m + 1, z, G, g);
    acc = add_resid(acc, r0, a0);
    acc = add_resid(acc, r1, a1);
  }
  if (m < end) {
    const float4 a0 = member_az<L, LP>(idx_agg, val_agg, m, z, G, g);
    acc = add_resid(acc, r[(long long)perm[m] * G + g], a0);
  }
  rc[t] = acc;
}

inline unsigned blocks(long long work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

template <int L>
int launch_vec(const void* idx_agg, const void* val_agg, const int* perm,
               const int* agg_ptr, const void* r, const void* z, void* rc,
               int n_coarse, int k, cudaStream_t s) {
  const int G = k / 4;
  restrict_residual_vec<L><<<blocks((long long)n_coarse * G), kThreads, 0,
                             s>>>(
      (const int4*)idx_agg, (const float4*)val_agg, perm, agg_ptr,
      (const float4*)r, (const float4*)z, (float4*)rc, n_coarse, G);
  return (int)cudaGetLastError();
}

template <int L>
int dispatch_vec(int want, const void* idx_agg, const void* val_agg,
                 const int* perm, const int* agg_ptr, const void* r,
                 const void* z, void* rc, int n_coarse, int k,
                 cudaStream_t s) {
  if (want == L)
    return launch_vec<L>(idx_agg, val_agg, perm, agg_ptr, r, z, rc, n_coarse,
                         k, s);
  if constexpr (L < kMaxL) {
    return dispatch_vec<L + 1>(want, idx_agg, val_agg, perm, agg_ptr, r, z,
                               rc, n_coarse, k, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// idx, val: [n, L] slabs; perm: [n], agg_ptr: [n_coarse + 1]; r, z:
// [n, k], rc: [n_coarse, k] float32; idx_agg, val_agg: the slabs in
// aggregate order, [n, 4 * ceil(L / 4)], or null.  All contiguous; r, z,
// rc and the copies 16-byte aligned when the copies are given.
extern "C" int repro_restrict_residual(const void* idx, const void* val,
                                       const void* perm, const void* agg_ptr,
                                       const void* idx_agg,
                                       const void* val_agg, const void* r,
                                       const void* z, void* rc, int n_coarse,
                                       int L, int k, void* stream) {
  const auto s = (cudaStream_t)stream;
  if ((long long)n_coarse * k == 0) return 0;
  if (idx_agg && val_agg && k % 4 == 0 && L >= 1 && L <= kMaxL)
    return dispatch_vec<1>(L, idx_agg, val_agg, (const int*)perm,
                           (const int*)agg_ptr, r, z, rc, n_coarse, k, s);
  restrict_residual_any<<<blocks((long long)n_coarse * k), kThreads, 0, s>>>(
      (const int*)idx, (const float*)val, (const int*)perm,
      (const int*)agg_ptr, (const float*)r, (const float*)z, (float*)rc,
      n_coarse, L, k);
  return (int)cudaGetLastError();
}
