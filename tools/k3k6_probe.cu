// Variants of K3 (restrict + residual) and K6 (selective scan), timed
// beside each other and beside the kernels they replace by
// tools/k3k6_probe.py.  Not part of the port.
//
// K3 variants, one output each, all bitwise equal to the plain version
// (members summed in ascending perm order, each member's L products in l
// order, every operation rounded on its own):
//   0  the previous kernel: one thread a (coarse row, column), runtime L
//   1  0 with L a template parameter (the slab row's loads in flight
//      together)
//   2  1 with one thread a (coarse row, 4 columns): z and r rows read as
//      float4
//   3  2 reading idx/val from a copy of the slabs in aggregate order,
//      rows padded to LP = 4 * ceil(L / 4) (16-byte row loads)
//   4  3 with one thread a coarse row (all k = 8 columns)
//   5  3 with two members' loads in flight
//   6  2 with two members' loads in flight
//
// K6: the previous kernel (one thread a channel, float32 inputs) as
// k6_old, the shipped kernel (src/repro_torch/kernels/csrc/ssm_scan.cu,
// included below) at 2 or 4 lanes a channel and runs of 16 or 32 steps
// as k6_new, and a copy of the shipped kernel's cp.async path as k6_mode,
// stripped or changed by MODE (only mode 0 computes the scan; the others
// time a part of it):
//   0  the shipped kernel
//   1  compute only: the first run is staged, later runs compute on its
//      rows without copies or barriers
//   2  copies, staging and stores only: the recurrence replaced by one add
//   3  no expf: da = dt * A
//   5  no y stores (the compiler then drops the state sum too)
#include <cuda_runtime.h>

#include "../src/repro_torch/kernels/csrc/ssm_scan.cu"

namespace k3 {

__global__ void v0(const int* __restrict__ idx, const float* __restrict__ val,
                   const int* __restrict__ perm,
                   const int* __restrict__ agg_ptr,
                   const float* __restrict__ r, const float* __restrict__ z,
                   float* __restrict__ rc, int n_coarse, int L, int k) {
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

template <int L>
__global__ void v1(const int* __restrict__ idx, const float* __restrict__ val,
                   const int* __restrict__ perm,
                   const int* __restrict__ agg_ptr,
                   const float* __restrict__ r, const float* __restrict__ z,
                   float* __restrict__ rc, int n_coarse, int k) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_coarse * k) return;
  long long c = t / k;
  int j = (int)(t - c * k);
  float acc = 0.0f;
  const int end = agg_ptr[c + 1];
  for (int m = agg_ptr[c]; m < end; ++m) {
    const long long i = perm[m];
    float zz[L], vr[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      vr[l] = val[i * L + l];
      zz[l] = z[(long long)idx[i * L + l] * k + j];
    }
    float az = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) az = __fadd_rn(az, __fmul_rn(vr[l], zz[l]));
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

// one member's residual on 4 columns, slab row read through perm
template <int L>
__device__ __forceinline__ float4 member_slab(
    const int* __restrict__ idx, const float* __restrict__ val, long long i,
    const float4* __restrict__ r, const float4* __restrict__ z, int G,
    int g, float4& rr) {
  float vr[L];
  float4 zz[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    vr[l] = val[i * L + l];
    zz[l] = z[(long long)idx[i * L + l] * G + g];
  }
  rr = r[i * G + g];
  float4 az = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int l = 0; l < L; ++l) az = madd(az, vr[l], zz[l]);
  return az;
}

// one member's residual on 4 columns, slab row read from the copy in
// aggregate order
template <int L, int LP>
__device__ __forceinline__ float4 member_copy(
    const int4* __restrict__ idx_p, const float4* __restrict__ val_p,
    long long m, const float4* __restrict__ z, int G, int g) {
  int ir[LP];
  float vr[LP];
#pragma unroll
  for (int l = 0; l < LP; l += 4) {
    const int4 iv = idx_p[m * (LP / 4) + l / 4];
    const float4 vv = val_p[m * (LP / 4) + l / 4];
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

template <int L>
__global__ void v2(const int* __restrict__ idx, const float* __restrict__ val,
                   const int* __restrict__ perm,
                   const int* __restrict__ agg_ptr,
                   const float4* __restrict__ r, const float4* __restrict__ z,
                   float4* __restrict__ rc, int n_coarse, int G) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_coarse * G) return;
  long long c = t / G;
  int g = (int)(t - c * G);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int end = agg_ptr[c + 1];
  for (int m = agg_ptr[c]; m < end; ++m) {
    float4 rr;
    const float4 az = member_slab<L>(idx, val, perm[m], r, z, G, g, rr);
    acc = add_resid(acc, rr, az);
  }
  rc[t] = acc;
}

template <int L>
__global__ void v6(const int* __restrict__ idx, const float* __restrict__ val,
                   const int* __restrict__ perm,
                   const int* __restrict__ agg_ptr,
                   const float4* __restrict__ r, const float4* __restrict__ z,
                   float4* __restrict__ rc, int n_coarse, int G) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_coarse * G) return;
  long long c = t / G;
  int g = (int)(t - c * G);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int end = agg_ptr[c + 1];
  int m = agg_ptr[c];
  for (; m + 1 < end; m += 2) {
    float4 r0, r1;
    const float4 a0 = member_slab<L>(idx, val, perm[m], r, z, G, g, r0);
    const float4 a1 = member_slab<L>(idx, val, perm[m + 1], r, z, G, g, r1);
    acc = add_resid(acc, r0, a0);
    acc = add_resid(acc, r1, a1);
  }
  if (m < end) {
    float4 r0;
    const float4 a0 = member_slab<L>(idx, val, perm[m], r, z, G, g, r0);
    acc = add_resid(acc, r0, a0);
  }
  rc[t] = acc;
}

template <int L, int LP>
__global__ void v3(const int4* __restrict__ idx_p,
                   const float4* __restrict__ val_p,
                   const int* __restrict__ perm,
                   const int* __restrict__ agg_ptr,
                   const float4* __restrict__ r, const float4* __restrict__ z,
                   float4* __restrict__ rc, int n_coarse, int G) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_coarse * G) return;
  long long c = t / G;
  int g = (int)(t - c * G);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int end = agg_ptr[c + 1];
  for (int m = agg_ptr[c]; m < end; ++m) {
    const float4 az = member_copy<L, LP>(idx_p, val_p, m, z, G, g);
    acc = add_resid(acc, r[(long long)perm[m] * G + g], az);
  }
  rc[t] = acc;
}

template <int L, int LP>
__global__ void v5(const int4* __restrict__ idx_p,
                   const float4* __restrict__ val_p,
                   const int* __restrict__ perm,
                   const int* __restrict__ agg_ptr,
                   const float4* __restrict__ r, const float4* __restrict__ z,
                   float4* __restrict__ rc, int n_coarse, int G) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_coarse * G) return;
  long long c = t / G;
  int g = (int)(t - c * G);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int end = agg_ptr[c + 1];
  int m = agg_ptr[c];
  for (; m + 1 < end; m += 2) {
    const float4 r0 = r[(long long)perm[m] * G + g];
    const float4 r1 = r[(long long)perm[m + 1] * G + g];
    const float4 a0 = member_copy<L, LP>(idx_p, val_p, m, z, G, g);
    const float4 a1 = member_copy<L, LP>(idx_p, val_p, m + 1, z, G, g);
    acc = add_resid(acc, r0, a0);
    acc = add_resid(acc, r1, a1);
  }
  if (m < end) {
    const float4 az = member_copy<L, LP>(idx_p, val_p, m, z, G, g);
    acc = add_resid(acc, r[(long long)perm[m] * G + g], az);
  }
  rc[t] = acc;
}

// one thread a coarse row, G = 2 float4 groups (k = 8)
template <int L, int LP>
__global__ void v4(const int4* __restrict__ idx_p,
                   const float4* __restrict__ val_p,
                   const int* __restrict__ perm,
                   const int* __restrict__ agg_ptr,
                   const float4* __restrict__ r, const float4* __restrict__ z,
                   float4* __restrict__ rc, int n_coarse) {
  constexpr int G = 2;
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_coarse) return;
  float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
  const int end = agg_ptr[c + 1];
  for (int m = agg_ptr[c]; m < end; ++m) {
    int ir[LP];
    float vr[LP];
#pragma unroll
    for (int l = 0; l < LP; l += 4) {
      const int4 iv = idx_p[(long long)m * (LP / 4) + l / 4];
      const float4 vv = val_p[(long long)m * (LP / 4) + l / 4];
      ir[l] = iv.x, ir[l + 1] = iv.y, ir[l + 2] = iv.z, ir[l + 3] = iv.w;
      vr[l] = vv.x, vr[l + 1] = vv.y, vr[l + 2] = vv.z, vr[l + 3] = vv.w;
    }
    float4 z0[L], z1[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      z0[l] = z[(long long)ir[l] * G];
      z1[l] = z[(long long)ir[l] * G + 1];
    }
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      a0 = madd(a0, vr[l], z0[l]);
      a1 = madd(a1, vr[l], z1[l]);
    }
    const long long i = perm[m];
    acc0 = add_resid(acc0, r[i * G], a0);
    acc1 = add_resid(acc1, r[i * G + 1], a1);
  }
  rc[c * G] = acc0;
  rc[c * G + 1] = acc1;
}

constexpr int kThreads = 256;

inline unsigned blocks(long long work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

template <int L>
int run(int v, const int* idx, const float* val, const int* perm,
        const int* agg_ptr, const int* idx_p, const float* val_p,
        const float* r, const float* z, float* rc, int nc, int k,
        cudaStream_t s) {
  constexpr int LP = (L + 3) / 4 * 4;
  const int G = k / 4;
  const auto* r4 = (const float4*)r;
  const auto* z4 = (const float4*)z;
  auto* rc4 = (float4*)rc;
  const auto* ip = (const int4*)idx_p;
  const auto* vp = (const float4*)val_p;
  if (v >= 2 && k % 4 != 0) return (int)cudaErrorInvalidValue;
  switch (v) {
    case 1:
      v1<L><<<blocks((long long)nc * k), kThreads, 0, s>>>(
          idx, val, perm, agg_ptr, r, z, rc, nc, k);
      break;
    case 2:
      v2<L><<<blocks((long long)nc * G), kThreads, 0, s>>>(
          idx, val, perm, agg_ptr, r4, z4, rc4, nc, G);
      break;
    case 3:
      v3<L, LP><<<blocks((long long)nc * G), kThreads, 0, s>>>(
          ip, vp, perm, agg_ptr, r4, z4, rc4, nc, G);
      break;
    case 4:
      if (k != 8) return (int)cudaErrorInvalidValue;
      v4<L, LP><<<blocks(nc), kThreads, 0, s>>>(ip, vp, perm, agg_ptr, r4,
                                                z4, rc4, nc);
      break;
    case 5:
      v5<L, LP><<<blocks((long long)nc * G), kThreads, 0, s>>>(
          ip, vp, perm, agg_ptr, r4, z4, rc4, nc, G);
      break;
    case 6:
      v6<L><<<blocks((long long)nc * G), kThreads, 0, s>>>(
          idx, val, perm, agg_ptr, r4, z4, rc4, nc, G);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace k3

namespace k6old {

constexpr int kBlk = 128;   // channels per block
constexpr int kRun = 32;    // time steps staged per pass

template <int NS>
__global__ void __launch_bounds__(kBlk) ssm_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ hT, int S, int di) {
  __shared__ float sB[kRun * NS];
  __shared__ float sC[kRun * NS];
  __shared__ float sX[kRun][kBlk];
  __shared__ float sD[kRun][kBlk];
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int d = blockIdx.x * kBlk + tid;
  const bool live = d < di;

  float h[NS], a[NS];
  if (live) {
    const float* hp = h0 + (b * di + d) * NS;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      h[n] = hp[n];
      a[n] = A[(long long)d * NS + n];
    }
  }
  const float* bRow = Bm + b * S * NS;
  const float* cRow = Cm + b * S * NS;
  const long long rowOff = b * S * di + d;   // (b, t = 0, d)

  for (int t0 = 0; t0 < S; t0 += kRun) {
    const int steps = min(kRun, S - t0);
    __syncthreads();   // the previous run's B/C are consumed
    for (int i = tid; i < steps * NS; i += kBlk) {
      sB[i] = bRow[(long long)t0 * NS + i];
      sC[i] = cRow[(long long)t0 * NS + i];
    }
    if (live) {
#pragma unroll
      for (int s = 0; s < kRun; ++s) {
        if (s < steps) {
          const long long off = rowOff + (long long)(t0 + s) * di;
          sX[s][tid] = x[off];
          sD[s][tid] = dt[off];
        }
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < steps; ++s) {
      const float xt = sX[s][tid];
      const float dtt = sD[s][tid];
      const float dx = __fmul_rn(dtt, xt);
      const float* bt = sB + s * NS;
      const float* ct = sC + s * NS;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float da = expf(__fmul_rn(dtt, a[n]));
        h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(dx, bt[n]));
      }
      float acc = __fmul_rn(h[0], ct[0]);
#pragma unroll
      for (int n = 1; n < NS; ++n) {
        acc = __fadd_rn(acc, __fmul_rn(h[n], ct[n]));
      }
      y[rowOff + (long long)(t0 + s) * di] = acc;
    }
  }
  if (live) {
    float* hp = hT + (b * di + d) * NS;
#pragma unroll
    for (int n = 0; n < NS; ++n) hp[n] = h[n];
  }
}

}  // namespace k6old

namespace k6v {

// the shipped kernel's cp.async path, with MODE's changes (generated from
// src/repro_torch/kernels/csrc/ssm_scan.cu; keep the two in step)
template <int NS, int LANES, int RUN, typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 2 * LANES) scan(
    const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ Bm, const T* __restrict__ Cm, long long b_bs,
    long long b_ts, long long c_bs, long long c_ts,
    const float* __restrict__ A, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ hT, int S, int di) {
  constexpr int SPL = NS / LANES;       // states a lane holds
  constexpr int CH = kThreads / LANES;  // channels a block covers
  constexpr int HALO = LANES - 1;       // steps the last lane lags lane 0
  constexpr int ROWS = RUN + HALO;      // row r: step t0 - HALO + r
  // +8 float2 (64 B) a row: the LANES skewed rows a warp reads at once
  // fall on distinct banks
  constexpr int PITCH = CH + 8;
  constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte copy moves
  constexpr bool ASYNC = true;
  constexpr int NBUF = 2;
  __shared__ float2 sXD[ROWS][PITCH];  // (dt, dt * x)
  __shared__ __align__(16) float sB[ROWS][NS];
  __shared__ __align__(16) float sC[ROWS][NS];
  // ASYNC: raw rows of this run and the next, [buffer][step][channel]
  __shared__ __align__(16) T rX[NBUF][RUN][ASYNC ? CH : 1];
  __shared__ __align__(16) T rD[NBUF][RUN][ASYNC ? CH : 1];
  __shared__ __align__(16) T rB[NBUF][RUN][ASYNC ? NS : 1];
  __shared__ __align__(16) T rC[NBUF][RUN][ASYNC ? NS : 1];

  const int tid = threadIdx.x;
  const int q = tid % LANES;
  const int c = tid / LANES;
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool live = d < di;

  float h[SPL], a[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    h[s] = live ? h0[(b * di + d) * NS + q * SPL + s] : 0.0f;
    a[s] = live ? A[(long long)d * NS + q * SPL + s] : 0.0f;
  }
  const T* xb = x + b * S * di + d0;
  const T* db = dt + b * S * di + d0;
  const T* bb = Bm + b * b_bs;
  const T* cb = Cm + b * c_bs;
  float* yb = y + b * S * di + d;
  float acc = 0.0f;  // this lane's partial sum from the last iteration

  // iteration j of a run: lane q advances its states to the run's step
  // j - q, staged in row j - q + HALO; `yq` is that step's y
  auto step = [&](int j, bool ok, float* yq) {
    float p[SPL];
    if (ok) {
      const int row = j - q + HALO;
      const float2 xd = sXD[row][c];
      float bt[SPL], ct[SPL];
      load_run(&sB[row][q * SPL], bt);
      load_run(&sC[row][q * SPL], ct);
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        if (MODE == 2) {
          h[s] = __fadd_rn(h[s], xd.y);
          p[s] = h[s];
        } else {
          const float arg = __fmul_rn(xd.x, a[s]);
          const float da = MODE == 3 ? arg : expf(arg);
          h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(xd.y, bt[s]));
          p[s] = __fmul_rn(h[s], ct[s]);
        }
      }
    }
    float sum = -0.0f;
    if (LANES > 1) {
      const float up = __shfl_up_sync(0xffffffffu, acc, 1);
      if (q > 0) sum = up;
    }
    if (ok) {
#pragma unroll
      for (int s = 0; s < SPL; ++s) sum = __fadd_rn(sum, p[s]);
      acc = sum;
      if (MODE != 5 && q == LANES - 1 && live) *yq = sum;
    }
  };

  // ASYNC: copy the raw rows of the run at t0 into buffer `buf`
  auto fetch = [&](int t0, int buf) {
    constexpr int XC = ASYNC ? CH / VEC : 1;  // 16-byte chunks a row
    constexpr int BC = ASYNC ? NS / VEC : 1;
    const int steps = min(RUN, S - t0);
    for (int i = tid; i < steps * XC; i += kThreads) {
      const int r = i / XC, cc = i % XC * VEC;
      if (d0 + cc < di) {  // di is a multiple of VEC
        const long long off = (long long)(t0 + r) * di + cc;
        cp_async16(&rX[buf][r][cc], xb + off);
        cp_async16(&rD[buf][r][cc], db + off);
      }
    }
    for (int i = tid; i < steps * BC; i += kThreads) {
      const int r = i / BC, n = i % BC * VEC;
      cp_async16(&rB[buf][r][n], bb + (long long)(t0 + r) * b_ts + n);
      cp_async16(&rC[buf][r][n], cb + (long long)(t0 + r) * c_ts + n);
    }
    cp_async_commit();
  };
  // row r of the run at t0 holds step t0 - HALO + r: rows HALO.. are this
  // run's, the first HALO the last run's, read again for the lagging lanes
  // (ASYNC: from the raw buffer of the last run, still intact; else from
  // device memory, through the cache)
  auto stage = [&](int t0, int steps, int buf) {
    for (int i = tid; i < (steps + HALO) * CH; i += kThreads) {
      const int r = i / CH, cc = i % CH, t = t0 - HALO + r;
      float xv = 0.0f, dv = 0.0f;
      if (t >= 0 && d0 + cc < di) {
        if constexpr (ASYNC) {
          const int rr = r >= HALO ? r - HALO : RUN - HALO + r;
          const int bf = r >= HALO ? buf : buf ^ 1;
          xv = to_f32(rX[bf][rr][cc]);
          dv = to_f32(rD[bf][rr][cc]);
        } else {
          const long long off = (long long)t * di + cc;
          xv = to_f32(xb[off]);
          dv = to_f32(db[off]);
        }
      }
      sXD[r][cc] = make_float2(dv, __fmul_rn(dv, xv));
    }
    for (int i = tid; i < (steps + HALO) * NS; i += kThreads) {
      const int r = i / NS, n = i % NS, t = t0 - HALO + r;
      float bv = 0.0f, cv = 0.0f;
      if (t >= 0) {
        if constexpr (ASYNC) {
          const int rr = r >= HALO ? r - HALO : RUN - HALO + r;
          const int bf = r >= HALO ? buf : buf ^ 1;
          bv = to_f32(rB[bf][rr][n]);
          cv = to_f32(rC[bf][rr][n]);
        } else {
          bv = to_f32(bb[(long long)t * b_ts + n]);
          cv = to_f32(cb[(long long)t * c_ts + n]);
        }
      }
      sB[r][n] = bv;
      sC[r][n] = cv;
    }
  };

  if constexpr (ASYNC) {
    if (S > 0) fetch(0, 0);
  }
  int t0 = 0, steps = 0;
  for (int run = 0; t0 < S; t0 += RUN, ++run) {
    steps = min(RUN, S - t0);
    if (MODE != 1 || run == 0) {
      cp_async_wait_all();
      __syncthreads();
      stage(t0, steps, run & 1);
      __syncthreads();
      if (MODE != 1 && t0 + RUN < S) fetch(t0 + RUN, (run + 1) & 1);
    }
    float* yq = yb + (long long)(t0 - q) * di;
    if (t0 >= HALO && steps == RUN) {  // every lane's step lies in [0, S)
#pragma unroll 16
      for (int j = 0; j < RUN; ++j, yq += di) step(j, true, yq);
    } else {
      for (int j = 0; j < steps; ++j, yq += di) step(j, t0 + j >= q, yq);
    }
  }
  // drain the skew: the lagging lanes' last steps, from the last run's rows
  t0 -= RUN;
  for (int j = steps; j < steps + HALO; ++j) {
    const int tau = t0 + j - q;
    step(j, tau >= 0 && tau < S, yb + (long long)tau * di);
  }

  if (live) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) hT[(b * di + d) * NS + q * SPL + s] = h[s];
  }
}

template <int LANES, int RUN, int MODE, typename T>
int run(const void* x, const void* dt, const void* Bm, const void* Cm,
        long long b_bs, long long b_ts, long long c_bs, long long c_ts,
        const void* A, const void* h0, void* y, void* hT, int batch, int S,
        int di, cudaStream_t st) {
  constexpr int CH = kThreads / LANES;
  const dim3 grid((unsigned)((di + CH - 1) / CH), (unsigned)batch);
  scan<16, LANES, RUN, T, MODE><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const T*)dt, (const T*)Bm, (const T*)Cm, b_bs, b_ts,
      c_bs, c_ts, (const float*)A, (const float*)h0, (float*)y, (float*)hT,
      S, di);
  return (int)cudaGetLastError();
}

}  // namespace k6v

// k6_mode: mode `mode` % 10 of the shipped design's cp.async path at state
// 16, bf16 inputs: 2 lanes a channel and runs of 32 steps (the shipped
// choice) below 10, 4 lanes and runs of 16 from 10 on.  Rows must be
// 16-byte aligned, as the LM path's are.
extern "C" int k6_mode(int mode, const void* x, const void* dt,
                       const void* Bm, const void* Cm, long long b_bs,
                       long long b_ts, long long c_bs, long long c_ts,
                       const void* A, const void* h0, void* y, void* hT,
                       int batch, int S, int di, void* stream) {
  const auto st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
#define K6V(ID, LN, RN, MD)                                              \
  if (mode == ID)                                                        \
    return k6v::run<LN, RN, MD, bf>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, \
                                    A, h0, y, hT, batch, S, di, st);
  K6V(0, 2, 32, 0) K6V(1, 2, 32, 1) K6V(2, 2, 32, 2) K6V(3, 2, 32, 3)
  K6V(5, 2, 32, 5) K6V(10, 4, 16, 0) K6V(11, 4, 16, 1) K6V(12, 4, 16, 2)
  K6V(13, 4, 16, 3) K6V(15, 4, 16, 5)
#undef K6V
  return (int)cudaErrorInvalidValue;
}

#define K3_CASE(LV)                                                        \
  case LV:                                                                 \
    return k3::run<LV>(v, idx, val, perm, agg_ptr, idx_p, val_p, r, z, rc, \
                       nc, k, s);

extern "C" int k3_probe(int v, const void* idx_, const void* val_,
                        const void* perm_, const void* agg_ptr_,
                        const void* idx_p_, const void* val_p_,
                        const void* r_, const void* z_, void* rc_, int nc,
                        int L, int k, void* stream) {
  const auto* idx = (const int*)idx_;
  const auto* val = (const float*)val_;
  const auto* perm = (const int*)perm_;
  const auto* agg_ptr = (const int*)agg_ptr_;
  const auto* idx_p = (const int*)idx_p_;
  const auto* val_p = (const float*)val_p_;
  const auto* r = (const float*)r_;
  const auto* z = (const float*)z_;
  auto* rc = (float*)rc_;
  const auto s = (cudaStream_t)stream;
  if (nc == 0) return 0;
  if (v == 0) {
    k3::v0<<<k3::blocks((long long)nc * k), k3::kThreads, 0, s>>>(
        idx, val, perm, agg_ptr, r, z, rc, nc, L, k);
    return (int)cudaGetLastError();
  }
  switch (L) {
    K3_CASE(2) K3_CASE(3) K3_CASE(4) K3_CASE(5) K3_CASE(6) K3_CASE(7)
    K3_CASE(8) K3_CASE(9) K3_CASE(10) K3_CASE(11) K3_CASE(12) K3_CASE(13)
    K3_CASE(14) K3_CASE(15) K3_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the previous K6 at state 16, float32 inputs, contiguous
extern "C" int k6_old(const void* x, const void* dt, const void* Bm,
                      const void* Cm, const void* A, const void* h0, void* y,
                      void* hT, int batch, int S, int di, void* stream) {
  const dim3 grid((unsigned)((di + k6old::kBlk - 1) / k6old::kBlk),
                  (unsigned)batch);
  k6old::ssm_scan_kernel<16><<<grid, k6old::kBlk, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)Bm, (const float*)Cm,
      (const float*)A, (const float*)h0, (float*)y, (float*)hT, S, di);
  return (int)cudaGetLastError();
}

// the shipped K6 at state 16 with `lanes` lanes a channel and runs of
// `run` steps
extern "C" int k6_new(int lanes, int run, int bf16, const void* x,
                      const void* dt, const void* Bm, const void* Cm,
                      long long b_bs, long long b_ts, long long c_bs,
                      long long c_ts, const void* A, const void* h0, void* y,
                      void* hT, int batch, int S, int di, void* stream) {
  const auto st = (cudaStream_t)stream;
#define K6_LAUNCH(LN, RN, T)                                              \
  if (lanes == LN && run == RN)                                           \
    return launch<16, LN, RN, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A, \
                                 h0, y, hT, batch, S, di, st);
  if (bf16) {
    K6_LAUNCH(2, 32, __nv_bfloat16) K6_LAUNCH(2, 16, __nv_bfloat16)
    K6_LAUNCH(4, 16, __nv_bfloat16)
  } else {
    K6_LAUNCH(2, 16, float) K6_LAUNCH(4, 16, float)
  }
#undef K6_LAUNCH
  return (int)cudaErrorInvalidValue;
}
