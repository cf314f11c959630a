// K6b (the selective scan's gradient) beside its variants, for
// tools/k6b_probe.py.  Not part of the port.
//
// The probe builds this file once a variant, one nvcc each, in parallel:
//   -DK6B_SPL=s -DK6B_RUN=r -DK6B_MODE=m: `k6b_variant` runs the copy
//     below of the library's design (src/repro_torch/kernels/csrc/
//     ssm_scan_bwd.cu: there 2 states a lane in both kernels, runs of
//     `repro_ssm_scan_bwd_run()` steps) at state 16, bf16 inputs, with s
//     states a lane in the reverse pass, runs of r steps and the MODE bits
//     m: 1 no expf (da = dt * A); 2 the reverse pass stages its last run
//     only; 4 no sums of dB and dC over the channels (the compiler then
//     drops their products too); 8 every state stored in a stack [B, S,
//     16, di] and read back in place of the recompute; 16 no sums over the
//     states (no ddt, dx); 32 the checkpoint kernel alone; 64 da
//     recomputed in the walk (a third expf), not kept in registers.  0, 8
//     and 64 compute the gradient.  -DK6B_MINB=b sets the blocks an SM the
//     reverse kernel's __launch_bounds__ ask for (its register cap);
//     -DK6B_SPLF=f the checkpoint kernel's states a lane (default 2).
//   -DK6B_PREV: `k6b_prev` runs the previous design, kept below as it
//     was: one thread a channel in blocks of 128, every state in a float32
//     stack [B, S, di, 16] written by its forward pass and read by its
//     reverse pass, a warp butterfly a step for dB and dC.
// The library's kernel itself is timed through its own entry.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifdef K6B_PREV
namespace prev {

constexpr int kThreads = 128;  // channels a block
constexpr int kWarp = 32;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the warp's 32 values summed by recursive halving: lane i adds lane
// i ^ off for off = 16, 8, 4, 2, 1; every lane ends with lane 0's sum,
// ((v0 + v16) + (v8 + v24)) + ... (a + b == b + a bit for bit)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int NS>
__device__ __forceinline__ void load_state(const float* __restrict__ p,
                                           float (&o)[NS]) {
#pragma unroll
  for (int s = 0; s < NS; s += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + s);
    o[s] = v.x, o[s + 1] = v.y, o[s + 2] = v.z, o[s + 3] = v.w;
  }
}

template <int NS>
__device__ __forceinline__ void store_state(float* __restrict__ p,
                                            const float (&o)[NS]) {
#pragma unroll
  for (int s = 0; s < NS; s += 4)
    *reinterpret_cast<float4*>(p + s) =
        make_float4(o[s], o[s + 1], o[s + 2], o[s + 3]);
}

template <int NS, typename T>
__global__ void __launch_bounds__(kThreads) ssm_scan_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ Bm, const T* __restrict__ Cm, long long b_bs,
    long long b_ts, long long c_bs, long long c_ts,
    const float* __restrict__ A, const float* __restrict__ h0,
    const float* __restrict__ dy, const float* __restrict__ dhT,
    float* __restrict__ hbuf, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ part_bc,
    float* __restrict__ part_a, float* __restrict__ dh0, int S, int di,
    int nw) {
  const int lane = threadIdx.x % kWarp;
  const long long b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int w = d / kWarp;  // this warp's partial
  const bool live = d < di;
  const long long row = b * S * di + d;  // [b, t, d] at row + t * di
  const long long st = b * di + d;       // [b, d, :] at st * NS
  // hbuf[b, t, d, :] at ((b * S + t) * di + d) * NS
  float* hb = hbuf + (b * S * di + d) * NS;
  const long long hstep = (long long)di * NS;
  const T* bb = Bm + b * b_bs;
  const T* cb = Cm + b * c_bs;

  float a[NS], h[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    a[s] = live ? A[(long long)d * NS + s] : 0.0f;
    h[s] = live ? h0[st * NS + s] : 0.0f;
  }

  // forward: K6's recurrence, every state but the last stored
  for (int t = 0; t < S; ++t) {
    float xv = 0.0f, dv = 0.0f, bt[NS];
    if (live) {
      xv = to_f32(x[row + (long long)t * di]);
      dv = to_f32(dt[row + (long long)t * di]);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) bt[s] = to_f32(bb[(long long)t * b_ts + s]);
    const float u = __fmul_rn(dv, xv);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float da = expf(__fmul_rn(dv, a[s]));
      h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(u, bt[s]));
    }
    if (live && t < S - 1) store_state(hb + t * hstep, h);
  }

  // reverse: h holds h_t, hp is read as h_{t-1}
  float g[NS], gA[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    g[s] = live ? dhT[st * NS + s] : 0.0f;
    gA[s] = 0.0f;
  }
  for (int t = S - 1; t >= 0; --t) {
    float xv = 0.0f, dv = 0.0f, yv = 0.0f, bt[NS], ct[NS], hp[NS];
    if (live) {
      xv = to_f32(x[row + (long long)t * di]);
      dv = to_f32(dt[row + (long long)t * di]);
      yv = dy[row + (long long)t * di];
      if (t > 0)
        load_state(hb + (t - 1) * hstep, hp);
      else
        load_state(h0 + st * NS, hp);
    } else {
#pragma unroll
      for (int s = 0; s < NS; ++s) hp[s] = 0.0f;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      bt[s] = to_f32(bb[(long long)t * b_ts + s]);
      ct[s] = to_f32(cb[(long long)t * c_ts + s]);
    }
    const float u = __fmul_rn(dv, xv);
    float da[NS], pb[NS], pc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      da[s] = expf(__fmul_rn(dv, a[s]));
      g[s] = __fadd_rn(g[s], __fmul_rn(yv, ct[s]));
      pc[s] = live ? __fmul_rn(yv, h[s]) : 0.0f;
      pb[s] = live ? __fmul_rn(g[s], u) : 0.0f;
    }
    float du = __fmul_rn(g[0], bt[0]);
#pragma unroll
    for (int s = 1; s < NS; ++s) du = __fadd_rn(du, __fmul_rn(g[s], bt[s]));
    float sa = 0.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float ga = __fmul_rn(__fmul_rn(g[s], hp[s]), da[s]);
      gA[s] = __fadd_rn(gA[s], __fmul_rn(ga, dv));
      const float term = __fmul_rn(ga, a[s]);
      sa = s == 0 ? term : __fadd_rn(sa, term);
      g[s] = __fmul_rn(g[s], da[s]);
      h[s] = hp[s];
    }
    if (live) {
      ddt[row + (long long)t * di] = __fadd_rn(sa, __fmul_rn(du, xv));
      dx[row + (long long)t * di] = __fmul_rn(du, dv);
    }
    // the warp's partial sums over its channels: lane s writes dB's state
    // s, lane NS + s dC's
    float out = 0.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float vb = warp_sum(pb[s]);
      const float vc = warp_sum(pc[s]);
      if (lane == s) out = vb;
      if (lane == NS + s) out = vc;
    }
    if (w < nw && lane < 2 * NS)
      part_bc[((b * S + t) * nw + w) * 2 * NS + lane] = out;
  }

  if (live) {
    store_state(dh0 + st * NS, g);
    store_state(part_a + st * NS, gA);
  }
}

// dB, dC [B, S, NS]: the nw warp partials added in warp order; dA [di,
// NS]: the B rows' partials added in row order
template <int NS>
__global__ void __launch_bounds__(kReduceThreads) ssm_scan_bwd_reduce_kernel(
    const float* __restrict__ part_bc, const float* __restrict__ part_a,
    float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ dA,
    int batch, int S, int di, int nw) {
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  const long long n_bc = (long long)batch * S * 2 * NS;
  if (i < n_bc) {
    const long long bt = i / (2 * NS);
    const int j = (int)(i % (2 * NS));
    const float* p = part_bc + bt * nw * 2 * NS + j;
    float acc = p[0];
    for (int w = 1; w < nw; ++w)
      acc = __fadd_rn(acc, p[(long long)w * 2 * NS]);
    if (j < NS)
      dB[bt * NS + j] = acc;
    else
      dC[bt * NS + j - NS] = acc;
  } else if (i < n_bc + (long long)di * NS) {
    const long long k = i - n_bc;
    float acc = part_a[k];
    for (int r = 1; r < batch; ++r)
      acc = __fadd_rn(acc, part_a[(long long)r * di * NS + k]);
    dA[k] = acc;
  }
}

template <int NS, typename T>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           long long b_bs, long long b_ts, long long c_bs, long long c_ts,
           const void* A, const void* h0, const void* dy, const void* dhT,
           void* hbuf, void* dx, void* ddt, void* part_bc, void* part_a,
           void* dh0, void* dB, void* dC, void* dA, int batch, int S, int di,
           cudaStream_t stream) {
  const int nw = (di + kWarp - 1) / kWarp;
  const dim3 grid((unsigned)((di + kThreads - 1) / kThreads),
                  (unsigned)batch);
  ssm_scan_bwd_kernel<NS, T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)dt, (const T*)Bm, (const T*)Cm, b_bs, b_ts,
      c_bs, c_ts, (const float*)A, (const float*)h0, (const float*)dy,
      (const float*)dhT, (float*)hbuf, (float*)dx, (float*)ddt,
      (float*)part_bc, (float*)part_a, (float*)dh0, S, di, nw);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long items = (long long)batch * S * 2 * NS + (long long)di * NS;
  const unsigned blocks =
      (unsigned)((items + kReduceThreads - 1) / kReduceThreads);
  ssm_scan_bwd_reduce_kernel<NS><<<blocks, kReduceThreads, 0, stream>>>(
      (const float*)part_bc, (const float*)part_a, (float*)dB, (float*)dC,
      (float*)dA, batch, S, di, nw);
  return (int)cudaGetLastError();
}

}  // namespace prev

// the previous design at state 16, bf16 inputs; hbuf [B, S, di, 16]
extern "C" int k6b_prev(const void* x, const void* dt, const void* Bm,
                        const void* Cm, long long b_bs, long long b_ts,
                        long long c_bs, long long c_ts, const void* A,
                        const void* h0, const void* dy, const void* dhT,
                        void* hbuf, void* dx, void* ddt, void* part_bc,
                        void* part_a, void* dh0, void* dB, void* dC,
                        void* dA, int batch, int S, int di, void* stream) {
  return prev::launch<16, __nv_bfloat16>(
      x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A, h0, dy, dhT, hbuf, dx, ddt,
      part_bc, part_a, dh0, dB, dC, dA, batch, S, di, (cudaStream_t)stream);
}
#else
namespace variant {

constexpr int kCh = 32;  // channels a block: the lanes of a warp
constexpr int kReduceThreads = 256;

// MODE bits
constexpr int kNoExp = 1;        // da = dt * A: no expf
constexpr int kNoStage = 2;      // the reverse stages its last run only
constexpr int kNoChanSum = 4;    // no sums of dB, dC over the channels
constexpr int kStack = 8;        // every state stored and read back: ck
                                 // holds [B, S, state, di]
constexpr int kNoStateSum = 16;  // no sums over the states: no ddt, dx
constexpr int kNoReverse = 32;   // the checkpoint kernel alone
constexpr int kExpInWalk = 64;   // da recomputed in the walk, not kept

template <bool V>
struct Flag {
  static constexpr bool value = V;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// N floats of shared memory at p (aligned to VW floats) to o, and back
template <int N, int VW>
__device__ __forceinline__ void lds(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < N; i += VW) {
    if constexpr (VW == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x, o[i + 1] = v.y, o[i + 2] = v.z, o[i + 3] = v.w;
    } else if constexpr (VW == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      o[i] = v.x, o[i + 1] = v.y;
    } else {
      o[i] = p[i];
    }
  }
}
template <int N, int VW>
__device__ __forceinline__ void sts(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += VW) {
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else if constexpr (VW == 2) {
      *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
    } else {
      p[i] = v[i];
    }
  }
}
__host__ __device__ constexpr int vec_width(int n) {
  return n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1;
}

// The sum of value v[k] over the warp's 32 lanes, for k = lane / (32 / N):
// a reduce-scatter (at offset OFF a lane keeps the half of its values
// that bit OFF of its lane selects, and adds its partner's copy of them),
// then a butterfly over the offsets left.  Every add joins the lanes i
// and i ^ off, from off = 16 down: the halving tree (pairs i, i + 16;
// then i, i + 8; ...) whichever lane ends with the sum.  Left in v[0].
template <int N, int OFF, int V>
__device__ __forceinline__ void lane_sum(float (&v)[V], int lane) {
  if constexpr (N > 1) {
    const bool hi = lane & OFF;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float lo_v = v[i], hi_v = v[N / 2 + i];
      const float got = __shfl_xor_sync(0xffffffffu, hi ? lo_v : hi_v, OFF);
      v[i] = __fadd_rn(hi ? hi_v : lo_v, got);
    }
    lane_sum<N / 2, OFF / 2>(v, lane);
  } else {
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1)
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], off));
  }
}

__host__ __device__ constexpr int al16(int n) { return (n + 15) / 16 * 16; }

// The forward pass (the library's `ssm_scan_ckpt_kernel`, with SPL states
// a lane and runs of R): K6's recurrence from h0 to the state before the
// last run, the state stored at every run boundary (kStack: every state);
// its inputs loaded in windows of kFw steps as they are staged.
constexpr int kFw = 64;
template <int NS, int SPL, int R, typename T, int MODE>
__global__ void __launch_bounds__(kCh * NS / SPL, 1024 / kCh / NS * SPL)
    ssm_scan_ckpt_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                         const T* __restrict__ Bm, long long b_bs,
                         long long b_ts, const float* __restrict__ A,
                         const float* __restrict__ h0,
                         float* __restrict__ ck, int S, int di) {
  constexpr int W = NS / SPL, THREADS = kCh * W;
  __shared__ float2 sDU[kFw * kCh];             // (dt, dt * x)
  __shared__ __align__(16) float sB[kFw * NS];  // [kFw][W][SPL]

  const int tid = threadIdx.x, lane = tid % kCh, q = tid / kCh;
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * kCh, d = d0 + lane;
  const bool live = d < di;
  const int nruns = (S + R - 1) / R;
  const long long slots = (MODE & kStack) ? S : nruns - 1;
  const int tf = (MODE & kStack) ? S : (nruns - 1) * R;
  const T* xb = x + b * S * di + d0;
  const T* db = dt + b * S * di + d0;
  const T* bb = Bm + b * b_bs;
  float a[SPL], h[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    a[s] = live ? A[(long long)d * NS + q * SPL + s] : 0.0f;
    h[s] = live ? h0[(b * di + d) * NS + q * SPL + s] : 0.0f;
  }
  auto stage = [&](int t0, int steps) {
    for (int i = tid; i < steps * kCh; i += THREADS) {
      const int r = i / kCh, cc = i % kCh;
      float xv = 0.0f, dv = 0.0f;
      if (d0 + cc < di) {
        const long long off = (long long)(t0 + r) * di + cc;
        xv = to_f32(xb[off]);
        dv = to_f32(db[off]);
      }
      sDU[i] = make_float2(dv, __fmul_rn(dv, xv));
    }
    for (int i = tid; i < steps * NS; i += THREADS) {
      const int r = i / NS, n = i % NS;
      sB[(r * W + n / SPL) * SPL + n % SPL] =
          to_f32(bb[(long long)(t0 + r) * b_ts + n]);
    }
  };
  auto step = [&](int j, int t) {
    const float2 du = sDU[j * kCh + lane];
    float bv[SPL];
    lds<SPL, vec_width(SPL)>(sB + (j * W + q) * SPL, bv);
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const float arg = __fmul_rn(du.x, a[s]);
      const float da = (MODE & kNoExp) ? arg : expf(arg);
      h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(du.y, bv[s]));
    }
    if (live && ((MODE & kStack) || (t + 1) % R == 0)) {
      const long long k = (MODE & kStack) ? t : (t + 1) / R - 1;
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        ck[((b * slots + k) * NS + q * SPL + s) * di + d] = h[s];
    }
  };
  for (int t0 = 0; t0 < tf; t0 += kFw) {
    const int steps = min(kFw, tf - t0);
    __syncthreads();  // the last window computed
    stage(t0, steps);
    __syncthreads();
    if (steps == kFw) {
#pragma unroll 16
      for (int j = 0; j < kFw; ++j) step(j, t0 + j);
    } else {
      for (int j = 0; j < steps; ++j) step(j, t0 + j);
    }
  }
}

// The reverse kernel's shared memory, in bytes from the start of the
// dynamic buffer: the staged inputs of two runs (the one walked, and the
// one staged beside its sums), the run's terms and its partials
template <int NS, int SPL, int R>
struct Layout {
  static constexpr int W = NS / SPL;     // warps a block
  static constexpr int PT = NS + SPL;    // a term row's pitch, in floats:
                                         // the lanes' vector stores and
                                         // loads fall on distinct banks
  static constexpr int du = 0;                          // float2 [2][R][kCh]
  static constexpr int dy = du + al16(2 * R * kCh * 8);  // float [2][R][kCh]
  static constexpr int x = dy + al16(2 * R * kCh * 4);   // float [2][R][kCh]
  static constexpr int bc = x + al16(2 * R * kCh * 4);   // [2][R][W][2 SPL]
  static constexpr int tu = bc + al16(2 * R * NS * 2 * 4);  // [R][kCh][PT]
  static constexpr int ts = tu + al16(R * kCh * PT * 4);    // [R][kCh][PT]
  static constexpr int part = ts + al16(R * kCh * PT * 4);  // [R][2 NS]
  static constexpr int bytes = part + al16(R * 2 * NS * 4);
};

// MINB blocks an SM: at most 128 registers a thread while the run (2 R
// SPL values) fits in 64 (two blocks of 256 threads an SM), else up to
// 255
__host__ __device__ constexpr int min_blocks(int threads, int run_regs) {
  return run_regs <= 64 && threads <= 512 ? 512 / threads : 1;
}

// The reverse pass: the runs from the last, each recomputed from its
// checkpoint and walked back (the file's header); each run loaded from
// device memory as it is staged, beside the sums of the run after it.
template <int NS, int SPL, int R, typename T, int MODE, int MINB>
__global__ void __launch_bounds__(kCh * NS / SPL, MINB)
    ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        long long b_bs, long long b_ts, long long c_bs,
                        long long c_ts, const float* __restrict__ A,
                        const float* __restrict__ h0,
                        const float* __restrict__ dy,
                        const float* __restrict__ dhT,
                        const float* __restrict__ ck, float* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ part_bc,
                        float* __restrict__ part_a, float* __restrict__ dh0,
                        int S, int di, int nw) {
  using L = Layout<NS, SPL, R>;
  constexpr int W = L::W, THREADS = kCh * W, PT = L::PT;
  extern __shared__ __align__(16) unsigned char smem[];
  // staged run m in buffer m & 1: (dt, dt * x), dy and x a channel, and a
  // state group's B then its C
  float2* sDU = reinterpret_cast<float2*>(smem + L::du);
  float* sDY = reinterpret_cast<float*>(smem + L::dy);
  float* sX = reinterpret_cast<float*>(smem + L::x);
  float* sBC = reinterpret_cast<float*>(smem + L::bc);
  float* sTU = reinterpret_cast<float*>(smem + L::tu);  // g[n] * B_t[n]
  float* sTS = reinterpret_cast<float*>(smem + L::ts);  // ga[n] * A[n]
  float* sP = reinterpret_cast<float*>(smem + L::part);  // dB_t, dC_t

  const int tid = threadIdx.x;
  const int lane = tid % kCh;  // the channel
  const int q = tid / kCh;     // the state group
  const long long b = blockIdx.y;
  const int blk = blockIdx.x;
  const int d0 = blk * kCh;
  const int d = d0 + lane;
  const bool live = d < di;
  const int nruns = (S + R - 1) / R;
  const long long slots = (MODE & kStack) ? S : nruns - 1;
  const T* xb = x + b * S * di + d0;
  const T* db = dt + b * S * di + d0;
  const float* yb = dy + b * S * di + d0;
  const T* bb = Bm + b * b_bs;
  const T* cb = Cm + b * c_bs;
  const long long st = (b * di + d) * NS + q * SPL;  // [b, d, q SPL]

  float a[SPL], g[SPL], gA[SPL], cur[SPL], nxt[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    a[s] = live ? A[(long long)d * NS + q * SPL + s] : 0.0f;
    g[s] = live ? dhT[st + s] : 0.0f;
    gA[s] = 0.0f;
  }
  // slot k of ck, this thread's first state; its state s at + s * di
  auto ck_at = [&](long long k) {
    return ck + ((b * slots + k) * NS + q * SPL) * di + d;
  };
  // the state before run k: h0 for k = 0, else its checkpoint
  auto load_start = [&](int k, float* o) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      if (!live)
        o[s] = 0.0f;
      else if (k == 0)
        o[s] = h0[st + s];
      else
        o[s] = ck_at((MODE & kStack) ? (long long)k * R - 1 : k - 1)[s * di];
    }
  };

  // stage the `steps` steps from t0 as float32 into staged buffer `buf`;
  // channels past di stage zeros
  auto stage = [&](int t0, int steps, int buf) {
    for (int i = tid; i < steps * kCh; i += THREADS) {
      const int r = i / kCh, cc = i % kCh, k = buf * R * kCh + i;
      float xv = 0.0f, dv = 0.0f, yv = 0.0f;
      if (d0 + cc < di) {
        const long long off = (long long)(t0 + r) * di + cc;
        xv = to_f32(xb[off]);
        dv = to_f32(db[off]);
        yv = yb[off];
      }
      sDU[k] = make_float2(dv, __fmul_rn(dv, xv));
      sDY[k] = yv;
      sX[k] = xv;
    }
    for (int i = tid; i < steps * NS; i += THREADS) {
      const int r = i / NS, n = i % NS;
      float* o = sBC + ((buf * R + r) * W + n / SPL) * 2 * SPL + n % SPL;
      o[0] = to_f32(bb[(long long)(t0 + r) * b_ts + n]);
      o[SPL] = to_f32(cb[(long long)(t0 + r) * c_ts + n]);
    }
  };

  // run k (staged in buffer `buf`): its R states recomputed from `cur`,
  // then its steps walked back; the terms of the sums to shared memory
  auto walk = [&](auto full, int t0, int steps, int buf) {
    constexpr bool FULL = decltype(full)::value;
    const float2* du_ = sDU + buf * R * kCh + lane;
    const float* dy_ = sDY + buf * R * kCh + lane;
    const float* bc_ = sBC + (buf * R * W + q) * 2 * SPL;
    float hr[R][SPL], dar[R][SPL];
    float hp[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) hp[s] = cur[s];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (FULL || j < steps) {
        const float2 du = du_[j * kCh];
        float bc[2 * SPL];
        lds<2 * SPL, vec_width(2 * SPL)>(bc_ + j * W * 2 * SPL, bc);
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          const float arg = __fmul_rn(du.x, a[s]);
          const float da = (MODE & kNoExp) ? arg : expf(arg);
          if constexpr (!(MODE & kExpInWalk)) dar[j][s] = da;
          if constexpr ((MODE & kStack) != 0) {
            hr[j][s] = live ? ck_at(t0 + j)[s * di] : 0.0f;
          } else {
            hp[s] = __fadd_rn(__fmul_rn(da, hp[s]), __fmul_rn(du.y, bc[s]));
            hr[j][s] = hp[s];
          }
        }
      }
    }
#pragma unroll
    for (int j = R - 1; j >= 0; --j) {
      if (FULL || j < steps) {
        const float2 du = du_[j * kCh];
        const float yv = dy_[j * kCh];
        float bc[2 * SPL], tu[SPL], ts[SPL], v[2 * SPL];
        lds<2 * SPL, vec_width(2 * SPL)>(bc_ + j * W * 2 * SPL, bc);
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          if constexpr ((MODE & kExpInWalk) != 0) {
            const float arg = __fmul_rn(du.x, a[s]);
            dar[j][s] = (MODE & kNoExp) ? arg : expf(arg);
          }
          const float hprev = j > 0 ? hr[j > 0 ? j - 1 : 0][s] : cur[s];
          g[s] = __fadd_rn(g[s], __fmul_rn(yv, bc[SPL + s]));
          // the terms of dC_t and dB_t: +0.0f past di (dy, u, h and g
          // are +0.0f there)
          v[SPL + s] = __fmul_rn(yv, hr[j][s]);
          v[s] = __fmul_rn(g[s], du.y);
          tu[s] = __fmul_rn(g[s], bc[s]);
          const float ga = __fmul_rn(__fmul_rn(g[s], hprev), dar[j][s]);
          gA[s] = __fadd_rn(gA[s], __fmul_rn(ga, du.x));
          ts[s] = __fmul_rn(ga, a[s]);
          g[s] = __fmul_rn(g[s], dar[j][s]);
        }
        sts<SPL, vec_width(SPL)>(sTU + (j * kCh + lane) * PT + q * SPL, tu);
        sts<SPL, vec_width(SPL)>(sTS + (j * kCh + lane) * PT + q * SPL, ts);
        if constexpr (!(MODE & kNoChanSum)) {
          lane_sum<2 * SPL, kCh / 2>(v, lane);
          constexpr int G = kCh / (2 * SPL);  // lanes that hold each sum
          if (lane % G == 0) {
            const int k = lane / G;  // v's index: dB's states, then dC's
            const int col = k < SPL ? q * SPL + k : NS + q * SPL + k - SPL;
            sP[j * 2 * NS + col] = v[0];
          }
        }
      }
    }
  };

  // after run k's walk: du and the A term summed over n in order, one
  // (step, channel) a thread, ddt and dx written; the block's dB, dC
  // partials written
  auto sums = [&](int t0, int steps, int buf) {
    if constexpr (!(MODE & kNoStateSum)) {
      for (int j = q; j < steps; j += W) {
        float tu[NS], ts[NS];
        lds<NS, vec_width(SPL)>(sTU + (j * kCh + lane) * PT, tu);
        lds<NS, vec_width(SPL)>(sTS + (j * kCh + lane) * PT, ts);
        float du = tu[0], sa = ts[0];
#pragma unroll
        for (int n = 1; n < NS; ++n) {
          du = __fadd_rn(du, tu[n]);
          sa = __fadd_rn(sa, ts[n]);
        }
        if (live) {
          const int k = (buf * R + j) * kCh + lane;
          const long long o = (b * S + t0 + j) * di + d;
          ddt[o] = __fadd_rn(sa, __fmul_rn(du, sX[k]));
          dx[o] = __fmul_rn(du, sDU[k].x);
        }
      }
    }
    for (int i = tid; i < steps * 2 * NS; i += THREADS) {
      const int r = i / (2 * NS), col = i % (2 * NS);
      part_bc[((b * S + t0 + r) * nw + blk) * 2 * NS + col] = sP[i];
    }
  };

  // run m is staged into buffer m & 1 beside the sums of run m + 1: two
  // barriers a run
  const int last = nruns - 1;
  if (nruns > 0) {
    load_start(last, nxt);
    stage(last * R, S - last * R, last & 1);
    __syncthreads();
  }
  for (int k = last; k >= 0; --k) {
    const int t0 = k * R, steps = min(R, S - t0);
    const int buf = (MODE & kNoStage) ? last & 1 : k & 1;
#pragma unroll
    for (int s = 0; s < SPL; ++s) cur[s] = nxt[s];
    if (steps == R)
      walk(Flag<true>(), t0, steps, buf);
    else
      walk(Flag<false>(), t0, steps, buf);
    if (k > 0) load_start(k - 1, nxt);  // read beside the sums
    __syncthreads();  // the walk's terms and partials in shared memory
    sums(t0, steps, buf);
    if (k > 0 && !(MODE & kNoStage)) stage(t0 - R, R, (k - 1) & 1);
    __syncthreads();  // run k - 1 staged; the terms summed
  }

  if (live) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      dh0[st + s] = g[s];
      part_a[st + s] = gA[s];
    }
  }
}

// dB, dC [B, S, NS]: the nw block partials added in block order; dA [di,
// NS]: the B rows' partials added in row order
template <int NS>
__global__ void __launch_bounds__(kReduceThreads) ssm_scan_bwd_reduce_kernel(
    const float* __restrict__ part_bc, const float* __restrict__ part_a,
    float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ dA,
    int batch, int S, int di, int nw) {
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  const long long n_bc = (long long)batch * S * 2 * NS;
  if (i < n_bc) {
    const long long bt = i / (2 * NS);
    const int j = (int)(i % (2 * NS));
    const float* p = part_bc + bt * nw * 2 * NS + j;
    float acc = p[0];
    for (int w = 1; w < nw; ++w)
      acc = __fadd_rn(acc, p[(long long)w * 2 * NS]);
    if (j < NS)
      dB[bt * NS + j] = acc;
    else
      dC[bt * NS + j - NS] = acc;
  } else if (i < n_bc + (long long)di * NS) {
    const long long k = i - n_bc;
    float acc = part_a[k];
    for (int r = 1; r < batch; ++r)
      acc = __fadd_rn(acc, part_a[(long long)r * di * NS + k]);
    dA[k] = acc;
  }
}

// the three launches of one call: the checkpoints (SPLF states a lane),
// the reverse pass (SPL states a lane, runs of R), the reduction
template <int NS, int SPL, int R, typename T, int MODE, int MINB, int SPLF>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           long long b_bs, long long b_ts, long long c_bs, long long c_ts,
           const void* A, const void* h0, const void* dy, const void* dhT,
           void* ck, void* dx, void* ddt, void* part_bc, void* part_a,
           void* dh0, void* dB, void* dC, void* dA, int batch, int S, int di,
           cudaStream_t stream) {
  const int nw = (di + kCh - 1) / kCh;
  const dim3 grid((unsigned)nw, (unsigned)batch);
  int err = 0;
  if (S > R || (MODE & kStack)) {
    ssm_scan_ckpt_kernel<NS, SPLF, R, T, MODE>
        <<<grid, kCh * NS / SPLF, 0, stream>>>(
            (const T*)x, (const T*)dt, (const T*)Bm, b_bs, b_ts,
            (const float*)A, (const float*)h0, (float*)ck, S, di);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  if (MODE & kNoReverse) return 0;
  const auto kernel = ssm_scan_bwd_kernel<NS, SPL, R, T, MODE, MINB>;
  constexpr int smem = Layout<NS, SPL, R>::bytes;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  kernel<<<grid, kCh * NS / SPL, smem, stream>>>(
      (const T*)x, (const T*)dt, (const T*)Bm, (const T*)Cm, b_bs, b_ts, c_bs,
      c_ts, (const float*)A, (const float*)h0, (const float*)dy,
      (const float*)dhT, (const float*)ck, (float*)dx, (float*)ddt,
      (float*)part_bc, (float*)part_a, (float*)dh0, S, di, nw);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const long long items = (long long)batch * S * 2 * NS + (long long)di * NS;
  const unsigned blocks =
      (unsigned)((items + kReduceThreads - 1) / kReduceThreads);
  ssm_scan_bwd_reduce_kernel<NS><<<blocks, kReduceThreads, 0, stream>>>(
      (const float*)part_bc, (const float*)part_a, (float*)dB, (float*)dC,
      (float*)dA, batch, S, di, nw);
  return (int)cudaGetLastError();
}

}  // namespace variant

#ifndef K6B_MINB
#define K6B_MINB \
  variant::min_blocks(variant::kCh * 16 / K6B_SPL, 2 * K6B_RUN * K6B_SPL)
#endif
#ifndef K6B_SPLF
#define K6B_SPLF 2
#endif
// the copy at state 16, bf16 inputs, K6B_SPL states a lane, runs of
// K6B_RUN steps, MODE K6B_MODE; ck sized for it
extern "C" int k6b_variant(const void* x, const void* dt, const void* Bm,
                           const void* Cm, long long b_bs, long long b_ts,
                           long long c_bs, long long c_ts, const void* A,
                           const void* h0, const void* dy, const void* dhT,
                           void* ck, void* dx, void* ddt, void* part_bc,
                           void* part_a, void* dh0, void* dB, void* dC,
                           void* dA, int batch, int S, int di,
                           void* stream) {
  return variant::launch<16, K6B_SPL, K6B_RUN, __nv_bfloat16, K6B_MODE,
                         K6B_MINB, K6B_SPLF>(
      x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A, h0, dy, dhT, ck, dx, ddt,
      part_bc, part_a, dh0, dB, dC, dA, batch, S, di, (cudaStream_t)stream);
}
#endif
