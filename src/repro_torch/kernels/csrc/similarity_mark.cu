// K4: strict-similarity marking pass of the recovery rounds,
// kill[j] = exists k: cseg[k] == eseg[j] and candidate k marks edge j,
// where k marks j iff (uu && vv) || (uv && vu) and, e.g.,
// uu = exists (a, b), a + b <= min(cbeta[k], c1 - 1): csu[k, a] == esu[j, b].
//
// Replaces the Pallas kernel `similarity_mark` (body `_sim_kernel`) of
// src/repro/kernels/similarity.py, including its static skip of the
// pairs with a + b > c1 - 1.
//
// What bounds it on the H100: bytes.  Every edge row reads its subtask id
// (4 bytes) and writes one byte; only a row that some recovered candidate
// (cbeta >= 0) of its own subtask could mark needs its two signatures
// (2 * c1 * 4 bytes), and in the round engine those are few.  The
// candidates are a few KB.
//
// Design.  The TPU kernel computed the whole dense K x tile block, because
// its vector unit wants dense work.  Here the work has two parts of very
// different size, and each gets its own shape: two kernels, back to back on
// the caller's stream.
//
//  * The row stream (`stream_kernel`).  A thread owns 16 consecutive rows:
//    it reads their subtask ids as four 16-byte loads and writes their 16
//    output bytes as one store, so a block of 256 threads covers 4096 rows
//    and the main path's 2 million rows take one wave of 512 blocks.  A
//    block finds the ranges of its rows' ids, one over the ids >= 0 and
//    one over the negative ids of padding rows (warp min/max, then shared
//    memory), and each of 128 threads tests one candidate against them;
//    one `__syncthreads_count` says whether any recovered candidate (cbeta
//    >= 0) lies in a range.  A block with none, nearly every block in the
//    round engine where rows are ordered by subtask, writes zeros and ends.
//  * The rows of the candidates' subtasks.  In a block that lists
//    candidates, a thread that lists one enters its subtask id in a hash
//    table of 256 slots (linear probing; the table is cleared in the first
//    phase), with a 128-bit set of the candidates listed under it.  Nothing
//    is sorted: the candidates may come in any order, their ids however far
//    apart.  The rows' ids then go through shared memory so that the count
//    takes rows t, t + 256, ...: a row inside the listed ids' range finds
//    its subtask's set in one or two probes, and its count of (row,
//    candidate) pairs is the set's size.  A block-wide prefix sum counts
//    the block's pairs.  Then one of two shapes:
//    - Few pairs (at most one a thread, as in the engine's first round):
//      they are laid out in row order and dealt out evenly over the
//      block's threads; thread t takes pairs t, t + 256, ..., finds the
//      pair's row by a binary search over the prefix and its candidate as
//      the n-th bit of the row's set, and runs that one pair's grid.
//    - Many (rows of large subtasks, up to 16 candidates each; one block
//      can hold over 100,000 pairs): the block appends those rows to a
//      list in device memory, each warp reserving room with one atomic
//      add.  The second kernel (`rows_kernel`, four blocks an SM,
//      launched as a programmatic dependent so that its launch overlaps
//      the stream's last blocks) stages every recovered candidate in
//      shared memory and deals the list out over the whole card, 16 lanes
//      a row: lane q runs the grids of the row's candidates q, q + 16, ...
//      (the engine gives a subtask at most 16) and stops at its first
//      mark.  So a launch's 100,000 grids take about one grid's time on
//      each lane of the card.  Rows past the list's capacity are walked in
//      the first kernel.
//  * The grid of a (row, candidate) pair tests only the pairs a + b <=
//    c1 - 1 (the static skip), without branches: each of the four
//    relations gathers its matches as bits over the diagonal a + b, and
//    one mask test keeps the diagonals a + b <= cbeta.
//
// The output is boolean, so it is bit-identical to the plain version
// whatever order the atomics list the candidates and the rows in.  C1 is a
// template parameter, so the unrolled loops index the signatures
// statically.  The list's length lives in one of two counters chosen by
// the parity of a launch number: a launch appends under its own and zeroes
// the other for the next launch, which the previous launch's second kernel
// has finished reading.  The caller zeroes both once.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                      // threads a block
constexpr int kRowsPerThread = 16;                 // consecutive rows a thread
constexpr int kRows = kThreads * kRowsPerThread;   // rows a block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;   // candidates listed a pass: a 128-bit set
constexpr int kSlots = 256;  // hash slots for their subtask ids
constexpr unsigned long long kEmpty = ~0ull;  // a free slot
constexpr int kLocalPairs = kThreads;  // pairs a block runs itself
constexpr int kLanesPerRow = 16;  // lanes of the rows kernel on one row
constexpr int kRowsBlocksPerSM = 4;
constexpr int kMaxC1 = 16;
static_assert(kRowsPerThread == 16, "one uint4 store a thread's rows");
static_assert(kTile == 128 && kTile <= kThreads, "a set is 4 words");
static_assert(kSlots == 256 && kSlots > kTile, "8-bit slots, never full");

// Shared index of row r of the block: one word of padding every 32 rows,
// so the 16 rows of each of a warp's threads fall in different banks.
__device__ __forceinline__ int padded(int r) { return r + (r >> 5); }

// The subtask ids of a thread's 16 rows from `base`; `live` of them lie
// below m.  Four 16-byte loads where the rows are whole and aligned.
__device__ __forceinline__ int load_segs(const int* __restrict__ eseg,
                                         long long base, int m, bool vec,
                                         int (&seg)[kRowsPerThread]) {
  const long long left = (long long)m - base;
  const int live = left <= 0 ? 0 : (left >= kRowsPerThread ? kRowsPerThread
                                                           : (int)left);
  if (vec && live == kRowsPerThread) {
    const int4* p = reinterpret_cast<const int4*>(eseg + base);
#pragma unroll
    for (int q = 0; q < kRowsPerThread / 4; ++q) {
      const int4 v = __ldg(p + q);
      seg[4 * q] = v.x;
      seg[4 * q + 1] = v.y;
      seg[4 * q + 2] = v.z;
      seg[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      seg[i] = i < live ? __ldg(eseg + base + i) : 0;
  }
  return live;
}

// First probe of subtask id s (Fibonacci hashing to 8 bits).
__device__ __forceinline__ unsigned home(int s) {
  return ((unsigned)s * 2654435761u) >> 24;
}

__device__ __forceinline__ void clear_table(unsigned long long* key,
                                            uint4* set, int t) {
  for (int h = t; h < kSlots; h += kThreads) {
    key[h] = kEmpty;
    set[h] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Enter listing slot i under subtask id s.
__device__ __forceinline__ void insert(unsigned long long* key, uint4* set,
                                       int s, int i) {
  const unsigned long long id = (unsigned)s;
  unsigned h = home(s);
  for (;;) {
    const unsigned long long was = atomicCAS(&key[h], kEmpty, id);
    if (was == kEmpty || was == id) break;
    h = (h + 1) & (kSlots - 1);
  }
  atomicOr(reinterpret_cast<unsigned*>(&set[h]) + (i >> 5), 1u << (i & 31));
}

// The slot that holds subtask id s, or -1.
__device__ __forceinline__ int find_slot(const unsigned long long* key,
                                         int s) {
  const unsigned long long want = (unsigned)s;
  for (unsigned h = home(s);; h = (h + 1) & (kSlots - 1)) {
    const unsigned long long k = key[h];
    if (k == want) return (int)h;
    if (k == kEmpty) return -1;
  }
}

// Position of the j-th set bit (from 0) of the 128-bit set w.
__device__ __forceinline__ int nth_bit(uint4 w, int j) {
  unsigned word = w.x;
  int at = 0, c = __popc(word);
  if (j >= c) {
    j -= c;
    word = w.y;
    at = 32;
    c = __popc(word);
    if (j >= c) {
      j -= c;
      word = w.z;
      at = 64;
      c = __popc(word);
      if (j >= c) {
        j -= c;
        word = w.w;
        at = 96;
      }
    }
  }
  for (; j > 0; --j) word &= word - 1;
  return at + __ffs(word) - 1;
}

// Edge j's two signatures.
template <int C1>
struct Edge {
  int u[C1], v[C1];
  __device__ __forceinline__ Edge(const int* __restrict__ esu,
                                  const int* __restrict__ esv, long long j) {
#pragma unroll
    for (int b = 0; b < C1; ++b) {
      u[b] = __ldg(esu + j * C1 + b);
      v[b] = __ldg(esv + j * C1 + b);
    }
  }
};

// The candidate with signatures (su, sv) and beta marks edge e: the
// (c1)^2 grid, pairs a + b <= c1 - 1 only, as bits over the diagonal a + b.
template <int C1>
__device__ __forceinline__ bool marks(const Edge<C1>& e, const int* su,
                                      const int* sv, int beta) {
  unsigned muu = 0, mvv = 0, muv = 0, mvu = 0;
#pragma unroll
  for (int a = 0; a < C1; ++a) {
    const int cu = su[a], cv = sv[a];
#pragma unroll
    for (int b = 0; a + b < C1; ++b) {
      const unsigned bit = 1u << (a + b);
      muu |= cu == e.u[b] ? bit : 0u;
      mvv |= cv == e.v[b] ? bit : 0u;
      muv |= cu == e.v[b] ? bit : 0u;
      mvu |= cv == e.u[b] ? bit : 0u;
    }
  }
  const int lim = beta < C1 - 1 ? beta : C1 - 1;
  const unsigned within = (2u << lim) - 1u;  // diagonals a + b <= lim
  return ((muu & within) && (mvv & within)) ||
         ((muv & within) && (mvu & within));
}

// Some candidate of the set (listing slots; candidate indices in s_k)
// marks edge e; the first mark ends the walk.
template <int C1>
__device__ __forceinline__ bool marked(uint4 set, const int* s_k,
                                       const int* __restrict__ csu,
                                       const int* __restrict__ csv,
                                       const int* __restrict__ cbeta,
                                       const Edge<C1>& e) {
  const unsigned words[4] = {set.x, set.y, set.z, set.w};
#pragma unroll
  for (int w = 0; w < 4; ++w)
    for (unsigned bits = words[w]; bits; bits &= bits - 1) {
      const long long k = s_k[32 * w + __ffs(bits) - 1];
      if (marks<C1>(e, csu + k * C1, csv + k * C1, __ldg(cbeta + k)))
        return true;
    }
  return false;
}

template <int C1>
__global__ void __launch_bounds__(kThreads, 4)
    stream_kernel(const int* __restrict__ csu, const int* __restrict__ csv,
                  const int* __restrict__ cbeta,
                  const int* __restrict__ cseg, const int* __restrict__ esu,
                  const int* __restrict__ esv, const int* __restrict__ eseg,
                  uint8_t* __restrict__ out, int K, int m, bool vec,
                  int* count, int* next_count, int* list, int capacity) {
  // per row: its subtask id, then (count << 8) | slot, then (its first
  // pair << 8) | slot where the block runs its own pairs
  __shared__ int s_row[kRows + kRows / 32];
  __shared__ unsigned s_kill[kRows / 32];        // marked rows, a bit each
  __shared__ unsigned long long s_key[kSlots];   // listed subtask ids
  __shared__ uint4 s_set[kSlots];  // their candidates, a bit a listing slot
  __shared__ int s_k[kTile];       // the candidate of a listing slot
  __shared__ int4 s_range[kWarps];  // per warp: lo, hi, negative lo, hi
  __shared__ int s_wsum[kWarps];
  __shared__ int s_n, s_cmin, s_cmax;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long base = row0 + (long long)t * kRowsPerThread;
  if (blockIdx.x == 0 && t == 0) *next_count = 0;

  // ---- the block's ranges of subtask ids ----------------------------------
  int seg[kRowsPerThread];
  const int live = load_segs(eseg, base, m, vec, seg);
  int lo = INT_MAX, hi = INT_MIN, nlo = INT_MAX, nhi = INT_MIN;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int s = seg[i];
    const bool pos = i < live && s >= 0, neg = i < live && s < 0;
    lo = pos ? min(lo, s) : lo;
    hi = pos ? max(hi, s) : hi;
    nlo = neg ? min(nlo, s) : nlo;
    nhi = neg ? max(nhi, s) : nhi;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  nlo = __reduce_min_sync(0xffffffffu, nlo);
  nhi = __reduce_max_sync(0xffffffffu, nhi);
  if (lane == 0) s_range[warp] = make_int4(lo, hi, nlo, nhi);
  if (t < kRows / 32) s_kill[t] = 0u;
  clear_table(s_key, s_set, t);
  if (t == 0) {
    s_n = 0;
    s_cmin = INT_MAX;
    s_cmax = INT_MIN;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int4 r = s_range[w];
    lo = min(lo, r.x);
    hi = max(hi, r.y);
    nlo = min(nlo, r.z);
    nhi = max(nhi, r.w);
  }

  for (int k0 = 0; k0 < K; k0 += kTile) {
    // ---- list the recovered candidates of the ranges --------------------
    const int nk = min(kTile, K - k0);
    bool listed = false;
    if (t < nk) {
      const int beta = __ldg(cbeta + k0 + t), sg = __ldg(cseg + k0 + t);
      listed = beta >= 0 && ((sg >= lo && sg <= hi) ||
                             (sg >= nlo && sg <= nhi));
      if (listed) {
        const int i = atomicAdd(&s_n, 1);
        s_k[i] = k0 + t;
        insert(s_key, s_set, sg, i);
        atomicMin(&s_cmin, sg);
        atomicMax(&s_cmax, sg);
      }
    }
    const int n = __syncthreads_count(listed);
    if (n == 0) continue;  // the same for the whole block

    // ---- each row's count of candidates of its subtask ------------------
    // the rows' ids go through shared memory so that the count takes rows
    // t, t + 256, ...: the candidates' own rows, often a few hundred in a
    // run, are spread over the threads instead of lying 16 to a thread
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      s_row[padded(t * kRowsPerThread + i)] = seg[i];
    __syncthreads();
    const int cmin = s_cmin, cmax = s_cmax;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int r = q * kThreads + t, at = padded(r);
      const int s = s_row[at];
      int run = 0;  // (count << 8) | slot
      if (row0 + r < m && s >= cmin && s <= cmax) {
        const int h = find_slot(s_key, s);
        if (h >= 0) {
          const uint4 w = s_set[h];
          run = ((__popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w))
                 << 8) | h;
        }
      }
      s_row[at] = run;
    }
    __syncthreads();

    // ---- the pairs: a block-wide exclusive prefix sum -------------------
    int total = 0;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      total += s_row[padded(t * kRowsPerThread + i)] >> 8;
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      incl += lane >= d ? v : 0;
    }
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    int pairs = 0, first = incl - total;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_wsum[w];
      first += w < warp ? v : 0;
      pairs += v;
    }

    if (pairs <= kLocalPairs || K > kTile) {
      // ---- few pairs: one a thread at a time, dealt out evenly ----------
      // each row's entry becomes (its first pair << 8) | slot
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int a = padded(t * kRowsPerThread + i);
        const int e = s_row[a];
        s_row[a] = (first << 8) | (e & 255);
        first += e >> 8;
      }
      __syncthreads();
      for (int p = t; p < pairs; p += kThreads) {
        int r = 0;  // the last row whose first pair is <= p
#pragma unroll
        for (int step = kRows / 2; step > 0; step >>= 1)
          if ((s_row[padded(r + step)] >> 8) <= p) r += step;
        if ((s_kill[r >> 5] >> (r & 31)) & 1u) continue;
        const int e = s_row[padded(r)];
        const long long k = s_k[nth_bit(s_set[e & 255], p - (e >> 8))];
        if (marks<C1>(Edge<C1>(esu, esv, row0 + r), csu + k * C1,
                      csv + k * C1, __ldg(cbeta + k)))
          atomicOr(&s_kill[r >> 5], 1u << (r & 31));
      }
    } else {
      // ---- many: list the rows, t, t + 256, ..., for the rows kernel ----
      unsigned hot = 0u;  // bit q: row q * 256 + t has candidates
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        hot |= (unsigned)(s_row[padded(q * kThreads + t)] >= 256) << q;
      const int mine = __popc(hot);
      int before = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, before, d);
        before += lane >= d ? v : 0;
      }
      // one atomic a warp; the count may pass the capacity, and the rows
      // past it are walked here
      int at = lane == 31 && before > 0 ? atomicAdd(count, before) : 0;
      at = __shfl_sync(0xffffffffu, at, 31) + before - mine;
      for (; hot; hot &= hot - 1, ++at) {
        const int r = (__ffs(hot) - 1) * kThreads + t;
        if (at < capacity) {
          list[at] = (int)(row0 + r);
        } else {  // the list is full: walk the row here
          const int e = s_row[padded(r)];
          if (marked<C1>(s_set[e & 255], s_k, csu, csv, cbeta,
                         Edge<C1>(esu, esv, row0 + r)))
            atomicOr(&s_kill[r >> 5], 1u << (r & 31));
        }
      }
    }
    __syncthreads();  // the tile's marks are final; its table is read
    if (k0 + kTile < K) {  // free the table for the next tile
      clear_table(s_key, s_set, t);
      if (t == 0) {
        s_n = 0;
        s_cmin = INT_MAX;
        s_cmax = INT_MIN;
      }
      __syncthreads();
    }
  }

  // ---- write the thread's 16 output bytes -------------------------------
  // the rows kernel may be scheduled once every block is here; it waits
  // for this grid's end before it reads the list
  asm volatile("griddepcontrol.launch_dependents;");
  if (live == 0) return;
  const unsigned bits = (s_kill[t >> 1] >> ((t & 1) * 16)) & 0xffffu;
  if (vec && live == kRowsPerThread) {
    // bit i of a nibble to byte i of a word: the four shifted copies of the
    // nibble do not overlap, so the product carries nothing
    uint4 w;
    w.x = ((bits & 0xfu) * 0x00204081u) & 0x01010101u;
    w.y = (((bits >> 4) & 0xfu) * 0x00204081u) & 0x01010101u;
    w.z = (((bits >> 8) & 0xfu) * 0x00204081u) & 0x01010101u;
    w.w = (((bits >> 12) & 0xfu) * 0x00204081u) & 0x01010101u;
    *reinterpret_cast<uint4*>(out + base) = w;
  } else {
    for (int i = 0; i < live; ++i) out[base + i] = (bits >> i) & 1u;
  }
}

// The listed rows, one a thread: walk the row's candidates (every
// recovered candidate of its subtask; rows are listed only where K <= 128)
// to the first mark, which writes 1 over the stream kernel's 0.
template <int C1>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const int* __restrict__ csu, const int* __restrict__ csv,
                const int* __restrict__ cbeta, const int* __restrict__ cseg,
                const int* __restrict__ esu, const int* __restrict__ esv,
                const int* __restrict__ eseg, uint8_t* __restrict__ out,
                int K, const int* count, const int* list, int capacity) {
  __shared__ unsigned long long s_key[kSlots];
  __shared__ uint4 s_set[kSlots];
  __shared__ int s_su[kTile * C1], s_sv[kTile * C1], s_beta[kTile];
  __shared__ int s_rows, s_n;
  const int t = threadIdx.x;
  // wait until the stream kernel has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (t == 0) {
    s_rows = min(__ldcg(count), capacity);
    s_n = 0;
  }
  clear_table(s_key, s_set, t);
  __syncthreads();
  const int rows = s_rows;
  // the same for the whole block: a block with no listed row to take ends
  if ((long long)blockIdx.x * (kThreads / kLanesPerRow) >= rows) return;
  if (t < K && __ldg(cbeta + t) >= 0) {  // stage every recovered candidate
    const int i = atomicAdd(&s_n, 1);
    s_beta[i] = __ldg(cbeta + t);
#pragma unroll
    for (int a = 0; a < C1; ++a) {
      s_su[i * C1 + a] = __ldg(csu + t * C1 + a);
      s_sv[i * C1 + a] = __ldg(csv + t * C1 + a);
    }
    insert(s_key, s_set, __ldg(cseg + t), i);
  }
  __syncthreads();
  // kLanesPerRow lanes a row; lane q of a row takes its candidates q,
  // q + kLanesPerRow, ... (the engine gives a subtask at most 16) and
  // stops at its first mark
  const int q = t % kLanesPerRow;
  for (long long g = ((long long)blockIdx.x * kThreads + t) / kLanesPerRow;
       g < rows; g += (long long)gridDim.x * kThreads / kLanesPerRow) {
    const int j = __ldcg(list + g);
    const Edge<C1> e(esu, esv, j);
    const uint4 set = s_set[find_slot(s_key, __ldg(eseg + j))];
    const int cnt = __popc(set.x) + __popc(set.y) + __popc(set.z) +
                    __popc(set.w);
    for (int c = q; c < cnt; c += kLanesPerRow) {
      const int i = nth_bit(set, c);
      if (marks<C1>(e, s_su + i * C1, s_sv + i * C1, s_beta[i])) {
        out[j] = 1;
        break;
      }
    }
  }
}

template <int C1>
int launch(const void* csu, const void* csv, const void* cbeta,
           const void* cseg, const void* esu, const void* esv,
           const void* eseg, void* out, int K, int m, int* counters,
           int* list, int capacity, int epoch, cudaStream_t stream) {
  const long long blocks = ((long long)m + kRows - 1) / kRows;
  const bool vec = (uintptr_t)eseg % 16 == 0 && (uintptr_t)out % 16 == 0;
  int* count = counters + (epoch & 1);
  stream_kernel<C1><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int*)csu, (const int*)csv, (const int*)cbeta, (const int*)cseg,
      (const int*)esu, (const int*)esv, (const int*)eseg, (uint8_t*)out, K,
      m, vec, count, counters + ((epoch + 1) & 1), list, capacity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static int sms_of[64];  // per device, read once
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  int& sms = sms_of[dev & 63];
  if (sms == 0 &&
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  // programmatic dependent launch: the rows kernel's blocks are scheduled
  // while the stream kernel runs, and start the moment it ends
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRowsBlocksPerSM * sms);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rows_kernel<C1>, (const int*)csu,
                           (const int*)csv, (const int*)cbeta,
                           (const int*)cseg, (const int*)esu,
                           (const int*)esv, (const int*)eseg, (uint8_t*)out,
                           K, (const int*)count, (const int*)list, capacity);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// `scratch`: 2 + capacity ints, its first two zero when first used; the
// launches of one stream share it, numbered by `epoch` (any integer that
// grows by one a launch).
extern "C" int repro_similarity_mark(const void* csu, const void* csv,
                                     const void* cbeta, const void* cseg,
                                     const void* esu, const void* esv,
                                     const void* eseg, void* out, int K,
                                     int m, int c1, void* scratch,
                                     int capacity, int epoch, void* stream) {
  if (m == 0) return 0;
  if (c1 < 1 || c1 > kMaxC1 || K < 0 || capacity < 0)
    return (int)cudaErrorInvalidValue;
  int* counters = (int*)scratch;
  int* list = counters + 2;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c1) {
#define REPRO_SIM_CASE(C)                                                \
  case C:                                                                \
    return launch<C>(csu, csv, cbeta, cseg, esu, esv, eseg, out, K, m,   \
                     counters, list, capacity, epoch, s);
    REPRO_SIM_CASE(1) REPRO_SIM_CASE(2) REPRO_SIM_CASE(3) REPRO_SIM_CASE(4)
    REPRO_SIM_CASE(5) REPRO_SIM_CASE(6) REPRO_SIM_CASE(7) REPRO_SIM_CASE(8)
    REPRO_SIM_CASE(9) REPRO_SIM_CASE(10) REPRO_SIM_CASE(11)
    REPRO_SIM_CASE(12) REPRO_SIM_CASE(13) REPRO_SIM_CASE(14)
    REPRO_SIM_CASE(15) REPRO_SIM_CASE(16)
#undef REPRO_SIM_CASE
  }
  return (int)cudaErrorInvalidValue;
}
