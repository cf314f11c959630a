// K7: the float64 residual r = b - L x of a graph Laplacian over its own
// CSR, with each column's mean and norm of r and, on request, the norm of b.
//
// Replaces no TPU kernel: the reference measures its solver's refinement
// residual on the host (`Graph.laplacian_matvec`, NumPy). The port keeps
// the solution on the card through the refinement and measures the residual
// here, with two launches a pass: this kernel, then its fold.
//
// What bounds it on the H100: bytes. A pass reads the CSR once (indptr, adj
// in int32, adj_w in float32), b in float32 and x in float64, and writes r
// in float64: 4 (n + 1) + 8 nnz + 20 n k bytes, 0.73 GB on a 2^20-vertex
// mesh at k = 32, 0.22 ms at 3.35 TB/s. A mesh's neighbours lie in a band
// of rows, so the gathered rows of x come from L2.
//
// Design: a warp spans a row's columns, so each gathered neighbour row of x
// is one coalesced read (256 B at k = 32), and the row's CSR entries are
// broadcast across its lanes; below 32 columns several rows share a warp,
// above 32 a block walks the columns in chunks of 32. Each thread walks a
// run of kRun rows of one column in order, summing r and r * r (and b * b)
// as it goes; a block holds kRuns runs and sums its runs' sums in run order
// through shared memory into one partial a column; the fold sums the
// blocks' partials in block order. The split of rows into runs and blocks
// does not depend on k, so a column's r, mean and norms have the same bits
// in a batch of any width.
//
// Numerics: float64 throughout, each operation rounded on its own (__d*_rn,
// and the library is built with -fmad=false). A row's weighted degree (the
// float64 sum of its float32 weights) and its neighbour sum run over the
// CSR in order, one term at a time (NumPy's reduceat in
// `Graph.laplacian_matvec`, the plain version, groups a row's terms its own
// way, so the two part by a rounding); the degree is never the float32
// diagonal of an ELL slab, whose rounding would swamp a 1e-3 residual on an
// ill-conditioned graph. b is promoted exactly.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // a block
constexpr int kRun = 8;                    // rows a thread sums in order
constexpr int kRuns = 32;                  // runs a block
constexpr int kRows = kRun * kRuns;        // rows a block: one partial
constexpr int kChunk = 32;                 // columns a pass over the block
constexpr int kFoldThreads = 128;
constexpr int kFoldBatch = 16;             // partials loaded ahead of adds

__global__ void __launch_bounds__(kThreads)
laplacian_residual_kernel(const int* __restrict__ indptr,
                          const int* __restrict__ adj,
                          const float* __restrict__ adj_w,
                          const float* __restrict__ b,
                          const double* __restrict__ x,
                          double* __restrict__ r,
                          double* __restrict__ part, int n, int k,
                          int with_b) {
  __shared__ double sums[3][kRuns][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int width = k < kChunk ? k : kChunk;    // lanes a row
  const int rows_a_warp = 32 / width;
  const bool live = lane < rows_a_warp * width;
  const int col_in = lane % width;
  const int first_run = warp * rows_a_warp + lane / width;
  const int run_step = (kThreads / 32) * rows_a_warp;
  const long long row0 = (long long)blockIdx.x * kRows;
  for (int c0 = 0; c0 < k; c0 += kChunk) {
    const int c = c0 + col_in;
    if (live && c < k) {
      for (int run = first_run; run < kRuns; run += run_step) {
        double s = 0.0, ss = 0.0, sb = 0.0;
        for (int t = 0; t < kRun; ++t) {
          const long long i = row0 + run * kRun + t;
          if (i >= n) break;
          const int j1 = indptr[i + 1];
          double deg = 0.0, nbr = 0.0;
          for (int j = indptr[i]; j < j1; ++j) {
            const double w = (double)adj_w[j];
            deg = __dadd_rn(deg, w);
            nbr = __dadd_rn(nbr, __dmul_rn(w, x[(long long)adj[j] * k + c]));
          }
          const long long e = i * k + c;
          const double bi = (double)b[e];
          const double ri = __dsub_rn(bi, __dsub_rn(__dmul_rn(deg, x[e]),
                                                     nbr));
          r[e] = ri;
          s = __dadd_rn(s, ri);
          ss = __dadd_rn(ss, __dmul_rn(ri, ri));
          sb = __dadd_rn(sb, __dmul_rn(bi, bi));
        }
        sums[0][run][col_in] = s;
        sums[1][run][col_in] = ss;
        sums[2][run][col_in] = sb;
      }
    }
    __syncthreads();
    if (threadIdx.x < 3 * kChunk) {
      const int q = threadIdx.x / kChunk;
      const int cc = threadIdx.x - q * kChunk;
      if (c0 + cc < k && (q < 2 || with_b)) {
        double acc = 0.0;
        for (int run = 0; run < kRuns; ++run) {
          acc = __dadd_rn(acc, sums[q][run][cc]);
        }
        part[((long long)blockIdx.x * 3 + q) * k + c0 + cc] = acc;
      }
    }
    __syncthreads();
  }
}

// out[0] the columns' means of r, out[1] their norms, out[2] the norms of
// b (with_b): the blocks' partials summed in block order.
__global__ void __launch_bounds__(kFoldThreads)
laplacian_residual_fold(const double* __restrict__ part,
                        double* __restrict__ out, int blocks, int n, int k,
                        int with_b) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 3LL * k) return;
  const int q = (int)(t / k);
  const int c = (int)(t - (long long)q * k);
  if (q == 2 && !with_b) return;
  const long long stride = 3LL * k;
  const double* p = part + (long long)q * k + c;
  double acc = 0.0;
  int blk = 0;
  for (; blk + kFoldBatch <= blocks; blk += kFoldBatch) {
    double v[kFoldBatch];
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) v[u] = p[(blk + u) * stride];
#pragma unroll
    for (int u = 0; u < kFoldBatch; ++u) acc = __dadd_rn(acc, v[u]);
  }
  for (; blk < blocks; ++blk) acc = __dadd_rn(acc, p[blk * stride]);
  out[t] = q == 0 ? __ddiv_rn(acc, (double)n) : __dsqrt_rn(acc);
}

}  // namespace

// Rows a block of the first launch sums into one partial: the wrapper
// sizes `part` as [ceil(n / rows), 3, k].
extern "C" int repro_laplacian_residual_rows() { return kRows; }

extern "C" int repro_laplacian_residual(const void* indptr, const void* adj,
                                        const void* adj_w, const void* b,
                                        const void* x, void* r, void* part,
                                        int n, int k, int with_b,
                                        void* stream) {
  if (n == 0 || k == 0) return 0;
  const long long blocks = ((long long)n + kRows - 1) / kRows;
  laplacian_residual_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int*)indptr, (const int*)adj, (const float*)adj_w,
      (const float*)b, (const double*)x, (double*)r, (double*)part, n, k,
      with_b);
  return (int)cudaGetLastError();
}

extern "C" int repro_laplacian_residual_fold(const void* part, void* out,
                                             int n, int k, int with_b,
                                             void* stream) {
  if (n == 0 || k == 0) return 0;
  const int blocks = (int)(((long long)n + kRows - 1) / kRows);
  const long long fold_blocks = (3LL * k + kFoldThreads - 1) / kFoldThreads;
  laplacian_residual_fold<<<(unsigned)fold_blocks, kFoldThreads, 0,
                            (cudaStream_t)stream>>>(
      (const double*)part, (double*)out, blocks, n, k, with_b);
  return (int)cudaGetLastError();
}
