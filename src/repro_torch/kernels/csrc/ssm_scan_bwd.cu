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
// What bounds it on the H100: latency, not a peak.  At hymba-1.5b's
// training shape (B = 4, S = 4096, di = 3200, state 16; bf16 x, dt, B, C,
// float32 dy) the function moves 0.84 GB (0.25 ms of device memory) and
// takes 23 operations a (b, t, d, n) cell, 0.29 ms at the float32 peak
// (`launch/roofline.py` `ssm_scan_bwd_launch`); this design takes 28 (a
// second pass of the forward recurrence) and moves its checkpoints and
// partial sums too (`ssm_scan_bwd_design`: 0.50 ms, bytes).  Each step of
// a lane is a chain of dependent rounded operations, two accurate expf a
// cell and the sums' shuffles and shared-memory trips; the reverse kernel
// holds 16 warps an SM (its registers and shared memory), too few to
// hide them.  A design that keeps every state in a float32 stack moves
// 6.7 GB more (3.36 GB written and read back), and one thread a channel
// leaves 3 warps an SM waiting on memory at every step.
//
// Design (tools/k6b_probe.py times each choice against its alternatives):
//   * Checkpointed runs, no state stack.  A checkpoint kernel runs K6's
//     recurrence from h0 (K6's order and rounding) and stores h only at
//     run boundaries, every kRun steps: ck [B, ceil(S / kRun) - 1, state,
//     di] float32, the state before each run but the first (0.21 GB at
//     the shape above); it stops at the last run, which only the reverse
//     pass needs.  The reverse kernel walks the runs from the last: it
//     recomputes a run's states from its checkpoint (the same bits as the
//     forward pass) and keeps them and their da = exp(dt A) in registers,
//     so the reverse step takes no third expf, then walks the run
//     backward.  Two kernels, so the checkpoint pass, which holds no run
//     in registers, runs 32 warps an SM.
//   * A grid that fills the card.  A block covers 32 channels of one batch
//     row: lane c of every warp is channel c, and warp q holds states
//     q * kSpl ... q * kSpl + kSpl - 1 of all 32 (at state 16: 8 warps a
//     block, 400 blocks at the shape above, 2 resident an SM in the
//     reverse kernel).
//   * Staged inputs.  Each run's rows are staged in shared memory as
//     float32: (dt, dt * x), dy and x a channel, B and C a state group.
//     The reverse kernel loads a run from device memory into a second
//     buffer beside the sums of the run after it, a run ahead of its
//     walk: two barriers a run.  The checkpoint kernel loads windows of
//     kFw steps as it stages them: two barriers a window.  No cp.async:
//     on the training path B and C are views of x_proj's rows (at
//     hymba's shape they start 200 bytes into rows of 264), which a
//     16-byte copy cannot read.  B and C are read through their row
//     strides: strided views need no copy.
//   * The sums over the states.  du and sum_n ga[n] A[n] run over n in
//     ascending order, across the warps: each step's terms go to shared
//     memory, and after the run one thread a (step, channel) adds them in
//     order and writes ddt and dx.
//   * The sums over the channels, in a fixed order (no float atomics; two
//     launches on the same inputs give the same bits).  dB_t and dC_t: a
//     warp's 32 lanes are the block's 32 channels; each lane halves the
//     values it holds at offsets 16, 8, ... (a reduce-scatter: it keeps
//     half, adds its partner's copy of that half), then a butterfly runs
//     over the offsets left.  Each add joins lanes c and c + off, so the
//     block's partial is the halving tree over its channels (pairs c,
//     c + 16, then c, c + 8, ...; a + b == b + a bit for bit), channels
//     past di adding 0.0f.  part_bc [B, S, ceil(di / 32), 2 state] holds
//     one partial a block and step; the reduce kernel adds them in block
//     order, the first block first.  dA: each thread sums its (channel,
//     state) terms over t (t = S-1 first) into part_a [B, di, state]; the
//     reduce kernel adds the rows in order, row 0 first.
// `kernels/ref.py` `ssm_scan_bwd_ref` (`warp_partials`, `group_sum`,
// `ssm_readout`) sums in the same orders, so every output, the reduced
// ones too, is bitwise equal to it on the card.
//
// Numerics: every operation rounded on its own (__fmul_rn/__fadd_rn; the
// library is built with -fmad=false), accurate expf, bf16 -> f32 exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;   // channels a block: the lanes of a warp
constexpr int kSpl = 2;   // states a lane, in both kernels
constexpr int kRun = 16;  // steps a run: the checkpoints' spacing
constexpr int kFw = 64;   // steps a window of the checkpoint kernel
constexpr int kReduceThreads = 256;

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

// The forward pass: K6's recurrence from h0 (K6's order and rounding) to
// the state before the last run, the state stored at every run boundary.
// A block covers 32 channels of one batch row, lane c of every warp
// channel c, warp q states q * kSpl ... of all 32; its inputs staged in
// windows of kFw steps.  Up to 64 registers a thread, so 1024 threads an
// SM.
template <int NS, typename T>
__global__ void __launch_bounds__(kCh * NS / kSpl, 1024 / kCh / NS * kSpl)
    ssm_scan_ckpt_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                         const T* __restrict__ Bm, long long b_bs,
                         long long b_ts, const float* __restrict__ A,
                         const float* __restrict__ h0,
                         float* __restrict__ ck, int S, int di) {
  constexpr int W = NS / kSpl, THREADS = kCh * W;
  __shared__ float2 sDU[kFw * kCh];               // (dt, dt * x)
  __shared__ __align__(16) float sB[kFw * NS];  // [kFw][W][kSpl]

  const int tid = threadIdx.x, lane = tid % kCh, q = tid / kCh;
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * kCh, d = d0 + lane;
  const bool live = d < di;
  const int nruns = (S + kRun - 1) / kRun;
  const long long slots = nruns - 1;
  const int tf = (nruns - 1) * kRun;
  const T* xb = x + b * S * di + d0;
  const T* db = dt + b * S * di + d0;
  const T* bb = Bm + b * b_bs;
  float a[kSpl], h[kSpl];
#pragma unroll
  for (int s = 0; s < kSpl; ++s) {
    a[s] = live ? A[(long long)d * NS + q * kSpl + s] : 0.0f;
    h[s] = live ? h0[(b * di + d) * NS + q * kSpl + s] : 0.0f;
  }

  // the window at t0 as float32, from device memory; channels past di
  // stage zeros
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
      sB[(r * W + n / kSpl) * kSpl + n % kSpl] =
          to_f32(bb[(long long)(t0 + r) * b_ts + n]);
    }
  };
  auto step = [&](int j, int t) {
    const float2 du = sDU[j * kCh + lane];
    float bv[kSpl];
    lds<kSpl, vec_width(kSpl)>(sB + (j * W + q) * kSpl, bv);
#pragma unroll
    for (int s = 0; s < kSpl; ++s) {
      const float da = expf(__fmul_rn(du.x, a[s]));
      h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(du.y, bv[s]));
    }
    if (live && (t + 1) % kRun == 0) {
      const long long k = (t + 1) / kRun - 1;
#pragma unroll
      for (int s = 0; s < kSpl; ++s)
        ck[((b * slots + k) * NS + q * kSpl + s) * di + d] = h[s];
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
template <int NS>
struct Layout {
  static constexpr int W = NS / kSpl;    // warps a block
  static constexpr int PT = NS + kSpl;   // a term row's pitch, in floats:
                                         // the lanes' vector stores and
                                         // loads fall on distinct banks
  static constexpr int R = kRun;
  static constexpr int du = 0;                          // float2 [2][R][kCh]
  static constexpr int dy = du + al16(2 * R * kCh * 8);  // float [2][R][kCh]
  static constexpr int x = dy + al16(2 * R * kCh * 4);   // float [2][R][kCh]
  static constexpr int bc = x + al16(2 * R * kCh * 4);   // [2][R][W][2 kSpl]
  static constexpr int tu = bc + al16(2 * R * NS * 2 * 4);  // [R][kCh][PT]
  static constexpr int ts = tu + al16(R * kCh * PT * 4);    // [R][kCh][PT]
  static constexpr int part = ts + al16(R * kCh * PT * 4);  // [R][2 NS]
  static constexpr int bytes = part + al16(R * 2 * NS * 4);
};

// The reverse pass: the runs from the last, each recomputed from its
// checkpoint and walked back (the file's header); each run loaded from
// device memory as it is staged, beside the sums of the run after it.
// The run (2 kRun kSpl values) fits in 64 registers, so the kernel asks
// for at most 128 a thread: 512 threads an SM (two blocks at state 16).
template <int NS, typename T>
__global__ void __launch_bounds__(kCh * NS / kSpl, 512 / kCh * kSpl / NS)
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
  using L = Layout<NS>;
  constexpr int W = L::W, THREADS = kCh * W, PT = L::PT, R = kRun;
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
  const long long slots = nruns - 1;
  const T* xb = x + b * S * di + d0;
  const T* db = dt + b * S * di + d0;
  const float* yb = dy + b * S * di + d0;
  const T* bb = Bm + b * b_bs;
  const T* cb = Cm + b * c_bs;
  const long long st = (b * di + d) * NS + q * kSpl;  // [b, d, q kSpl]

  float a[kSpl], g[kSpl], gA[kSpl], cur[kSpl], nxt[kSpl];
#pragma unroll
  for (int s = 0; s < kSpl; ++s) {
    a[s] = live ? A[(long long)d * NS + q * kSpl + s] : 0.0f;
    g[s] = live ? dhT[st + s] : 0.0f;
    gA[s] = 0.0f;
  }
  // the state before run k: h0 for k = 0, else its checkpoint (slot
  // k - 1 of ck; this thread's state s at + s * di)
  auto load_start = [&](int k, float* o) {
#pragma unroll
    for (int s = 0; s < kSpl; ++s) {
      if (!live)
        o[s] = 0.0f;
      else if (k == 0)
        o[s] = h0[st + s];
      else
        o[s] = ck[((b * slots + k - 1) * NS + q * kSpl + s) * di + d];
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
      float* o = sBC + ((buf * R + r) * W + n / kSpl) * 2 * kSpl + n % kSpl;
      o[0] = to_f32(bb[(long long)(t0 + r) * b_ts + n]);
      o[kSpl] = to_f32(cb[(long long)(t0 + r) * c_ts + n]);
    }
  };

  // a run (staged in buffer `buf`): its states recomputed from `cur`,
  // then its steps walked back; the terms of the sums to shared memory
  auto walk = [&](auto full, int steps, int buf) {
    constexpr bool FULL = decltype(full)::value;
    const float2* du_ = sDU + buf * R * kCh + lane;
    const float* dy_ = sDY + buf * R * kCh + lane;
    const float* bc_ = sBC + (buf * R * W + q) * 2 * kSpl;
    float hr[R][kSpl], dar[R][kSpl];
    float hp[kSpl];
#pragma unroll
    for (int s = 0; s < kSpl; ++s) hp[s] = cur[s];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (FULL || j < steps) {
        const float2 du = du_[j * kCh];
        float bc[2 * kSpl];
        lds<2 * kSpl, vec_width(2 * kSpl)>(bc_ + j * W * 2 * kSpl, bc);
#pragma unroll
        for (int s = 0; s < kSpl; ++s) {
          dar[j][s] = expf(__fmul_rn(du.x, a[s]));
          hp[s] = __fadd_rn(__fmul_rn(dar[j][s], hp[s]),
                            __fmul_rn(du.y, bc[s]));
          hr[j][s] = hp[s];
        }
      }
    }
#pragma unroll
    for (int j = R - 1; j >= 0; --j) {
      if (FULL || j < steps) {
        const float2 du = du_[j * kCh];
        const float yv = dy_[j * kCh];
        float bc[2 * kSpl], tu[kSpl], ts[kSpl], v[2 * kSpl];
        lds<2 * kSpl, vec_width(2 * kSpl)>(bc_ + j * W * 2 * kSpl, bc);
#pragma unroll
        for (int s = 0; s < kSpl; ++s) {
          const float hprev = j > 0 ? hr[j > 0 ? j - 1 : 0][s] : cur[s];
          g[s] = __fadd_rn(g[s], __fmul_rn(yv, bc[kSpl + s]));
          // the terms of dC_t and dB_t: +0.0f past di (dy, u, h and g
          // are +0.0f there)
          v[kSpl + s] = __fmul_rn(yv, hr[j][s]);
          v[s] = __fmul_rn(g[s], du.y);
          tu[s] = __fmul_rn(g[s], bc[s]);
          const float ga = __fmul_rn(__fmul_rn(g[s], hprev), dar[j][s]);
          gA[s] = __fadd_rn(gA[s], __fmul_rn(ga, du.x));
          ts[s] = __fmul_rn(ga, a[s]);
          g[s] = __fmul_rn(g[s], dar[j][s]);
        }
        sts<kSpl, vec_width(kSpl)>(sTU + (j * kCh + lane) * PT + q * kSpl,
                                   tu);
        sts<kSpl, vec_width(kSpl)>(sTS + (j * kCh + lane) * PT + q * kSpl,
                                   ts);
        lane_sum<2 * kSpl, kCh / 2>(v, lane);
        constexpr int G = kCh / (2 * kSpl);  // lanes that hold each sum
        if (lane % G == 0) {
          const int k = lane / G;  // v's index: dB's states, then dC's
          const int col =
              k < kSpl ? q * kSpl + k : NS + q * kSpl + k - kSpl;
          sP[j * 2 * NS + col] = v[0];
        }
      }
    }
  };

  // after a run's walk: du and the A term summed over n in order, one
  // (step, channel) a thread, ddt and dx written; the block's dB, dC
  // partials written
  auto sums = [&](int t0, int steps, int buf) {
    for (int j = q; j < steps; j += W) {
      float tu[NS], ts[NS];
      lds<NS, vec_width(kSpl)>(sTU + (j * kCh + lane) * PT, tu);
      lds<NS, vec_width(kSpl)>(sTS + (j * kCh + lane) * PT, ts);
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
    const int t0 = k * R, steps = min(R, S - t0), buf = k & 1;
#pragma unroll
    for (int s = 0; s < kSpl; ++s) cur[s] = nxt[s];
    if (steps == R)
      walk(Flag<true>(), steps, buf);
    else
      walk(Flag<false>(), steps, buf);
    if (k > 0) load_start(k - 1, nxt);  // read beside the sums
    __syncthreads();  // the walk's terms and partials in shared memory
    sums(t0, steps, buf);
    if (k > 0) stage(t0 - R, R, (k - 1) & 1);
    __syncthreads();  // run k - 1 staged; the terms summed
  }

  if (live) {
#pragma unroll
    for (int s = 0; s < kSpl; ++s) {
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

// the three launches of one call: the checkpoints (when S > kRun), the
// reverse pass, the reduction
template <int NS, typename T>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           long long b_bs, long long b_ts, long long c_bs, long long c_ts,
           const void* A, const void* h0, const void* dy, const void* dhT,
           void* ck, void* dx, void* ddt, void* part_bc, void* part_a,
           void* dh0, void* dB, void* dC, void* dA, int batch, int S, int di,
           cudaStream_t stream) {
  constexpr int threads = kCh * NS / kSpl, smem = Layout<NS>::bytes;
  const int nw = (di + kCh - 1) / kCh;
  const dim3 grid((unsigned)nw, (unsigned)batch);
  int err = 0;
  if (S > kRun) {
    ssm_scan_ckpt_kernel<NS, T><<<grid, threads, 0, stream>>>(
        (const T*)x, (const T*)dt, (const T*)Bm, b_bs, b_ts, (const float*)A,
        (const float*)h0, (float*)ck, S, di);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  err = (int)cudaFuncSetAttribute(ssm_scan_bwd_kernel<NS, T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err != 0) return err;
  ssm_scan_bwd_kernel<NS, T><<<grid, threads, smem, stream>>>(
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

template <typename T>
int launch_state(int state, const void* x, const void* dt, const void* Bm,
                 const void* Cm, long long b_bs, long long b_ts,
                 long long c_bs, long long c_ts, const void* A,
                 const void* h0, const void* dy, const void* dhT, void* ck,
                 void* dx, void* ddt, void* part_bc, void* part_a, void* dh0,
                 void* dB, void* dC, void* dA, int batch, int S, int di,
                 cudaStream_t st) {
  switch (state) {
    case 4:
      return launch<4, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A, h0, dy,
                          dhT, ck, dx, ddt, part_bc, part_a, dh0, dB, dC, dA,
                          batch, S, di, st);
    case 8:
      return launch<8, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A, h0, dy,
                          dhT, ck, dx, ddt, part_bc, part_a, dh0, dB, dC, dA,
                          batch, S, di, st);
    case 16:
      return launch<16, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A, h0, dy,
                           dhT, ck, dx, ddt, part_bc, part_a, dh0, dB, dC,
                           dA, batch, S, di, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The run length: the steps between two checkpoints, which size ck.
extern "C" int repro_ssm_scan_bwd_run() { return kRun; }

// x, dt: [batch, S, di] contiguous; Bm, Cm: [batch, S, state] with unit
// stride over state and the given batch (b_bs, c_bs) and step (b_ts, c_ts)
// strides in elements; all four bf16 (bf16 = 1) or all float32 (bf16 =
// 0).  A [di, state], h0, dhT, dh0 [batch, di, state], dy, dx, ddt
// [batch, S, di], dB, dC [batch, S, state], dA [di, state]: float32,
// contiguous.  Scratch, float32: ck [batch, ceil(S / run) - 1, state, di]
// with run = repro_ssm_scan_bwd_run(), part_bc [batch, S, ceil(di / 32),
// 2 state], part_a [batch, di, state].  state is 4, 8 or 16; batch, di
// >= 1.  Three launches: the checkpoints (when S > run), the reverse
// pass, the reduction of its partials.
extern "C" int repro_ssm_scan_bwd(
    const void* x, const void* dt, const void* Bm, const void* Cm,
    long long b_bs, long long b_ts, long long c_bs, long long c_ts,
    const void* A, const void* h0, const void* dy, const void* dhT, void* ck,
    void* dx, void* ddt, void* part_bc, void* part_a, void* dh0, void* dB,
    void* dC, void* dA, int batch, int S, int di, int state, int bf16,
    void* stream) {
  const auto st = (cudaStream_t)stream;
  if (bf16)
    return launch_state<__nv_bfloat16>(state, x, dt, Bm, Cm, b_bs, b_ts,
                                       c_bs, c_ts, A, h0, dy, dhT, ck, dx,
                                       ddt, part_bc, part_a, dh0, dB, dC, dA,
                                       batch, S, di, st);
  return launch_state<float>(state, x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A,
                             h0, dy, dhT, ck, dx, ddt, part_bc, part_a, dh0,
                             dB, dC, dA, batch, S, di, st);
}
