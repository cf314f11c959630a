// K6b: the gradient of K6 (the Mamba1 selective scan), the reverse-time
// scan.  Forward, per (batch row b, channel d), with a = exp(dt A) and
// u = dt x:
//   h_t = a_t * h_{t-1} + u_t * B_t,   y_t = sum_n h_t[n] * C_t[n].
// Given dy [B, S, di] and dhT [B, di, state], it carries g (the gradient
// of h_t) back from dhT; for t = S-1 ... 0:
//   g    = g + dy_t * C_t
//   dC_t = sum_d dy_t[d] * h_t[d, :]     dB_t = sum_d g[d, :] * u_t[d]
//   du   = sum_n g[n] * B_t[n]           ga   = (g * h_{t-1}) * a_t
//   dA  += ga * dt_t                     ddt  = (sum_n ga[n] * A[n]) + du * x
//   dx   = du * dt_t                     g    = g * a_t
// and dh0 = g.  The y's D skip lies outside (autograd carries it).
//
// Replaces no TPU kernel.  The reference trains Mamba by differentiating
// its chunked `lax.scan` (src/repro/models/layers.py:424-450), which XLA
// compiles; the port's forward is K6, which has no gradient, and a plain
// step loop would be some 15 small operations a step (millions of
// launches a training step at S = 4096).  `kernels/ssm_scan.py`
// `SsmScan` runs K6 forward and this kernel backward.
//
// Where the states come from: scheme (a).  The scan kernel first runs the
// recurrence forward from h0 (K6's order and rounding, so the states are
// K6's bit for bit) and stores every h_t, t < S-1, in a scratch stack
// hbuf [B, S, di, state] float32 (the wrapper allocates it; transient:
// 4 x 4096 x 3200 x 16 x 4 B = 3.36 GB at hymba-1.5b's training shape,
// one layer at a time under the per-layer checkpoint), then runs the
// reverse loop reading h_{t-1} from the stack; h_t is carried in
// registers from the step before.
//
// Work split: one thread per (b, d), its state's h, g, A and the running
// dA in registers; a block covers 128 channels of one batch row.
//
// Fixed order for the sums across channels and rows (no float atomics;
// two launches on the same inputs give the same bits):
//   * dB_t and dC_t: each warp sums its 32 channels by a butterfly of
//     __shfl_xor_sync (offsets 16, 8, 4, 2, 1; every lane ends with the
//     same sum), and one lane a state writes the warp's partial to
//     part_bc [B, S, nw, 2 state] (nw = ceil(di / 32); channels past di
//     add 0.0f).  The reduce kernel then adds the nw partials in warp
//     order, the first warp first.
//   * dA: each thread sums its channel's terms over t (t = S-1 first)
//     into part_a [B, di, state]; the reduce kernel adds the rows in
//     order, row 0 first.
// `kernels/ref.py` `ssm_scan_bwd_ref` (`warp_partials`, `group_sum`)
// sums in the same order, so every output, the reduced ones too, is
// bitwise equal to it on the card.
//
// What bounds it: at hymba-1.5b's training shape (B = 4, S = 4096,
// di = 3200, state 16, bf16 x, dt, B, C) the function moves x, dt, dy,
// dx, ddt (bf16 in, float32 dy and out: some 0.84 GB) and the state
// stack, written and read once (6.7 GB): about 2.3 ms of device memory.
// Its two passes issue two accurate expf and 21 rounded operations a
// (b, t, d, n) cell and, a (b, t, warp), 2 state butterflies of 5 shuffles;
// with one thread a channel only 12,800 threads run (3 warps an SM), so
// the loop's latency, not a peak, sets its time.  A simple kernel that is
// right; making it fast is later work.
//
// Numerics: every operation rounded on its own (__fmul_rn/__fadd_rn; the
// library is built with -fmad=false), accurate expf, bf16 -> f32 exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T>
int launch_state(int state, const void* x, const void* dt, const void* Bm,
                 const void* Cm, long long b_bs, long long b_ts,
                 long long c_bs, long long c_ts, const void* A,
                 const void* h0, const void* dy, const void* dhT, void* hbuf,
                 void* dx, void* ddt, void* part_bc, void* part_a, void* dh0,
                 void* dB, void* dC, void* dA, int batch, int S, int di,
                 cudaStream_t st) {
  switch (state) {
    case 4:
      return launch<4, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A, h0, dy,
                          dhT, hbuf, dx, ddt, part_bc, part_a, dh0, dB, dC,
                          dA, batch, S, di, st);
    case 8:
      return launch<8, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A, h0, dy,
                          dhT, hbuf, dx, ddt, part_bc, part_a, dh0, dB, dC,
                          dA, batch, S, di, st);
    case 16:
      return launch<16, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A, h0, dy,
                           dhT, hbuf, dx, ddt, part_bc, part_a, dh0, dB, dC,
                           dA, batch, S, di, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dt: [batch, S, di] contiguous; Bm, Cm: [batch, S, state] with unit
// stride over state and the given batch (b_bs, c_bs) and step (b_ts, c_ts)
// strides in elements; all four bf16 (bf16 = 1) or all float32 (bf16 =
// 0).  A [di, state], h0, dhT, dh0 [batch, di, state], dy, dx, ddt
// [batch, S, di], dB, dC [batch, S, state], dA [di, state]: float32,
// contiguous.  Scratch, float32: hbuf [batch, S, di, state], part_bc
// [batch, S, ceil(di / 32), 2 state], part_a [batch, di, state].  state
// is 4, 8 or 16; batch, di >= 1.  Two launches: the scan, then the
// reduction of its partials.
extern "C" int repro_ssm_scan_bwd(
    const void* x, const void* dt, const void* Bm, const void* Cm,
    long long b_bs, long long b_ts, long long c_bs, long long c_ts,
    const void* A, const void* h0, const void* dy, const void* dhT,
    void* hbuf, void* dx, void* ddt, void* part_bc, void* part_a, void* dh0,
    void* dB, void* dC, void* dA, int batch, int S, int di, int state,
    int bf16, void* stream) {
  const auto st = (cudaStream_t)stream;
  if (bf16)
    return launch_state<__nv_bfloat16>(state, x, dt, Bm, Cm, b_bs, b_ts,
                                       c_bs, c_ts, A, h0, dy, dhT, hbuf, dx,
                                       ddt, part_bc, part_a, dh0, dB, dC, dA,
                                       batch, S, di, st);
  return launch_state<float>(state, x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A,
                             h0, dy, dhT, hbuf, dx, ddt, part_bc, part_a, dh0,
                             dB, dC, dA, batch, S, di, st);
}
