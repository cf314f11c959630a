// K6: fused Mamba1 selective scan over a whole sequence,
//   h <- exp(dt * A) * h + (dt * x) * B,   y_t = sum_n h[n] * C_t[n],
// for every (batch row b, channel d); y is returned before the D skip.
//
// Replaces the Pallas kernel `ssm_scan` (body `_scan_kernel`) of
// src/repro/kernels/ssm_scan.py.  In the port it carries every Mamba
// layer's prefill scan (`models/layers.py` `mamba_scan` on a CUDA tensor).
//
// What bounds it on the H100: bytes, closely followed by the exponentials.
// At a falcon-mamba-7b prefill layer (B = 4, S = 2048, di = 8192,
// state 16) it reads x and dt (f32, 537 MB) once, B, C, A and h0
// (3.7 MB), and writes y (268 MB) and hT: 811 MB.  Each (b, t, d, n) cell
// costs one expf (a multi-function-unit op) and about six flops.
//
// Design: one thread per (b, d), holding h[state] and A[d, :] in
// registers; a block covers 128 channels of one batch row and walks the
// sequence in runs of 32 steps.  For each run the block stages B_t and C_t
// (shared by all channels of the row) in shared memory, and each thread
// stages its own 32 x and dt values there with independent loads, so a
// run's loads are in flight together; loads of x/dt and stores of y are
// coalesced over channels.  The TPU kernel's grid ran channel blocks in
// order on one core; here the channel blocks run in parallel and the time
// loop stays inside the thread.  Channels past di do no work (bound
// check), so any di is taken.
//
// Numerics: every operation is rounded on its own (__fmul_rn/__fadd_rn,
// and the library is built with -fmad=false), in the order of
// `_scan_kernel`: da = exp(dt * A), dbx = (dt * x) * B, h = da * h + dbx,
// and the sum over state runs n = 0..state-1 in order.  expf is the
// accurate one (no --use_fast_math).  The plain PyTorch version
// (`kernels/ref.py` `ssm_scan_ref`) runs the same order.
#include <cuda_runtime.h>

namespace {

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

template <int NS>
int launch(const float* x, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* h0, float* y, float* hT, int batch,
           int S, int di, cudaStream_t stream) {
  const dim3 grid((unsigned)((di + kBlk - 1) / kBlk), (unsigned)batch);
  ssm_scan_kernel<NS><<<grid, kBlk, 0, stream>>>(x, dt, Bm, Cm, A, h0, y, hT,
                                                 S, di);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt: [batch, S, di]; Bm, Cm: [batch, S, state]; A: [di, state];
// h0, hT: [batch, di, state]; y: [batch, S, di]; all float32, contiguous.
// state must be 4, 8 or 16 (the template instances); batch, di >= 1.
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* Bm,
                              const void* Cm, const void* A, const void* h0,
                              void* y, void* hT, int batch, int S, int di,
                              int state, void* stream) {
  const auto* fx = (const float*)x;
  const auto* fdt = (const float*)dt;
  const auto* fb = (const float*)Bm;
  const auto* fc = (const float*)Cm;
  const auto* fa = (const float*)A;
  const auto* fh = (const float*)h0;
  auto* fy = (float*)y;
  auto* fhT = (float*)hT;
  const auto st = (cudaStream_t)stream;
  switch (state) {
    case 4:
      return launch<4>(fx, fdt, fb, fc, fa, fh, fy, fhT, batch, S, di, st);
    case 8:
      return launch<8>(fx, fdt, fb, fc, fa, fh, fy, fhT, batch, S, di, st);
    case 16:
      return launch<16>(fx, fdt, fb, fc, fa, fh, fy, fhT, batch, S, di, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
