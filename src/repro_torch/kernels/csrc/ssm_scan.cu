// K6: fused Mamba1 selective scan over a whole sequence,
//   h <- exp(dt * A) * h + (dt * x) * B,   y_t = sum_n h[n] * C_t[n],
// for every (batch row b, channel d); y is returned before the D skip.
//
// Replaces the Pallas kernel `ssm_scan` (body `_scan_kernel`) of
// src/repro/kernels/ssm_scan.py.  In the port it carries every Mamba
// layer's prefill scan (`models/layers.py` `mamba_scan` on a CUDA tensor).
//
// What bounds it on the H100: instruction issue.  At a falcon-mamba-7b
// prefill layer (B = 4, S = 2048, di = 8192, state 16) it reads x and dt
// (bf16 on the serving path: 268 MB) once, B and C (strided views of the
// x_proj output) and A, h0, and writes y (f32, 268 MB): 0.16 ms of bytes.
// Each of the 1.07e9 (b, t, d, n) cells costs one accurate expf (one
// MUFU.EX2 and seven FP32-pipe instructions) and six more rounded flops:
// 14 issue slots a cell, some 0.45 ms at the full issue rate.
//
// Design:
//   * LANES = 2 lanes a channel, each holding NS / LANES of its states (h
//     and A in registers): at B = 4, 16 warps an SM, twice those of one
//     thread a channel, to hide the expf and shared-memory latencies.
//   * The state sum stays in ascending order n = 0..NS-1 through a skewed
//     pipeline: lane q runs its recurrence q steps behind lane 0, so at
//     each iteration it adds its states' products to the partial sum that
//     lane q-1 finished for the same step one iteration earlier (one
//     shuffle an iteration); lane LANES-1 writes y.  Lane 0 starts from
//     -0.0f, the exact identity of a rounded add.
//   * A block covers CH = 128 / LANES channels of one batch row and stages
//     runs of RUN steps in shared memory, with the LANES-1 steps before
//     the run that the lagging lanes still need: (dt, dt * x) per channel,
//     and B_t, C_t for the row.  The run's loop is unrolled, so every
//     shared-memory read of it is a fixed offset from the lane's base.
//     x, dt, B and C are read in their own type (bf16 or f32) and
//     converted while staging; B and C are read through their row
//     strides, so the caller's strided views of x_proj's output need no
//     copy.  Where every row starts on a 16-byte boundary (the serving
//     path's do), the next run's raw rows are copied with cp.async into a
//     second buffer while this run computes, so the whole grid, resident
//     at once and with no other work to switch to, does not wait on
//     device memory at every run; elsewhere each run is loaded as it is
//     staged.
//   * The channel blocks run in parallel; the time loop stays in the
//     block.  Channels past di do no work that is stored, so any di is
//     taken.
//
// tools/k3k6_probe.py times this kernel beside its variants (4 lanes,
// other run lengths) and stripped copies (no expf, no staging, ...).
//
// Numerics: every operation is rounded on its own (__fmul_rn/__fadd_rn,
// and the library is built with -fmad=false), in the order of
// `_scan_kernel`: da = exp(dt * A), dbx = (dt * x) * B, h = da * h + dbx,
// y = sum_n h[n] * C[n] over n in order.  bf16 -> f32 is exact.  expf is
// the accurate one (no --use_fast_math).  The plain PyTorch version
// (`kernels/ref.py` `ssm_scan_ref`) runs the same order, so the two agree
// bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes from global to shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// o[i] = p[i], i < N, from shared memory, in 16- or 8-byte loads where N
// allows (p is aligned to N floats)
template <int N>
__device__ __forceinline__ void load_run(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x, o[i + 1] = v.y, o[i + 2] = v.z, o[i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      o[i] = v.x, o[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

// ASYNC: the inputs' rows are 16-byte aligned (see `launch`), so each run
// is copied raw into shared memory with cp.async one run ahead, under the
// compute of the run before; else each run is loaded when it is staged.
template <int NS, int LANES, int RUN, typename T, bool ASYNC>
// at most 128 registers a thread at 2 lanes, so 4 blocks (16 warps) fit an
// SM: at B = 4, di = 8192 the whole grid is resident at once
__global__ void __launch_bounds__(kThreads, 2 * LANES) ssm_scan_kernel(
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
  constexpr int NBUF = ASYNC ? 2 : 1;
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
        const float da = expf(__fmul_rn(xd.x, a[s]));
        h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(xd.y, bt[s]));
        p[s] = __fmul_rn(h[s], ct[s]);
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
      if (q == LANES - 1 && live) *yq = sum;
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
    if constexpr (ASYNC) cp_async_wait_all();  // this run's raw rows
    __syncthreads();  // ... visible to all; the last run's rows consumed
    stage(t0, steps, run & 1);
    __syncthreads();
    if constexpr (ASYNC) {
      if (t0 + RUN < S) fetch(t0 + RUN, (run + 1) & 1);
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

inline bool aligned16(const void* p) { return (size_t)p % 16 == 0; }

template <int NS, int LANES, int RUN, typename T>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           long long b_bs, long long b_ts, long long c_bs, long long c_ts,
           const void* A, const void* h0, void* y, void* hT, int batch,
           int S, int di, cudaStream_t stream) {
  constexpr int CH = kThreads / LANES;
  constexpr long long es = sizeof(T);
  const dim3 grid((unsigned)((di + CH - 1) / CH), (unsigned)batch);
  const auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)dt, (const T*)Bm, (const T*)Cm, b_bs, b_ts,
        c_bs, c_ts, (const float*)A, (const float*)h0, (float*)y,
        (float*)hT, S, di);
    return (int)cudaGetLastError();
  };
  // every row a 16-byte copy reads starts on a 16-byte boundary
  const bool rows16 = aligned16(x) && aligned16(dt) && aligned16(Bm) &&
                      aligned16(Cm) && di * es % 16 == 0 &&
                      b_bs * es % 16 == 0 && b_ts * es % 16 == 0 &&
                      c_bs * es % 16 == 0 && c_ts * es % 16 == 0;
  if constexpr (NS * es % 16 == 0) {
    if (rows16) return args(ssm_scan_kernel<NS, LANES, RUN, T, true>);
  }
  return args(ssm_scan_kernel<NS, LANES, RUN, T, false>);
}

// 2 lanes a channel; runs of 32 steps for bf16 inputs, 16 for float32
// (whose raw rows of two runs would not fit the 48 KB of static shared
// memory)
template <typename T>
int launch_state(int state, const void* x, const void* dt, const void* Bm,
                 const void* Cm, long long b_bs, long long b_ts,
                 long long c_bs, long long c_ts, const void* A,
                 const void* h0, void* y, void* hT, int batch, int S, int di,
                 cudaStream_t st) {
  constexpr int RUN = sizeof(T) == 2 ? 32 : 16;
  switch (state) {
    case 4:
      return launch<4, 2, RUN, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A,
                                  h0, y, hT, batch, S, di, st);
    case 8:
      return launch<8, 2, RUN, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A,
                                  h0, y, hT, batch, S, di, st);
    case 16:
      return launch<16, 2, RUN, T>(x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A,
                                   h0, y, hT, batch, S, di, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dt: [batch, S, di] contiguous; Bm, Cm: [batch, S, state] with unit
// stride over state and the given batch (b_bs, c_bs) and step (b_ts, c_ts)
// strides in elements; x, dt, Bm and Cm all bf16 (bf16 = 1) or all float32
// (bf16 = 0).  A: [di, state], h0, hT: [batch, di, state], y: [batch, S,
// di], float32 and contiguous.  state must be 4, 8 or 16 (the template
// instances); batch, di >= 1.
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* Bm,
                              const void* Cm, long long b_bs, long long b_ts,
                              long long c_bs, long long c_ts, const void* A,
                              const void* h0, void* y, void* hT, int batch,
                              int S, int di, int state, int bf16,
                              void* stream) {
  const auto st = (cudaStream_t)stream;
  if (bf16)
    return launch_state<__nv_bfloat16>(state, x, dt, Bm, Cm, b_bs, b_ts, c_bs,
                                       c_ts, A, h0, y, hT, batch, S, di, st);
  return launch_state<float>(state, x, dt, Bm, Cm, b_bs, b_ts, c_bs, c_ts, A,
                             h0, y, hT, batch, S, di, st);
}
