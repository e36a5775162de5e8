// Linear sum assignment (Jonker-Volgenant) for Hopper (sm_90a).
//
// Replaces the JAX package's on-device solver `_lsa_rows`, vmapped by
// `hungarian` (snipper_tpu/matching/matcher.py:103-180). That solver is
// XLA (a `lax.fori_loop` over rows around two `lax.while_loop`s: the
// Dijkstra search and the augmentation), not Pallas; the port had moved
// it to scipy on the host, which stopped every train and eval step for a
// device-to-host copy. This kernel solves all P problems of a step (every
// decoder layer times the batch) in one launch and leaves the assignment
// on the device.
//
//   col4row[p, r] = the column assigned to row r of cost[p] (M <= N),
//   least total cost, rows = target slots, columns = queries.
//
// It is JAX's algorithm step for step in f32, so it gives JAX's
// assignment on every row, ties included: the reduced cost
// minval + cost[i][j] - u[i] - v[j] summed left to right, the strict
// red < sp[j] over unscanned columns, the lowest column among the least
// of where(scanned, 1e30, sp) (jnp.argmin's rule), the dual updates with
// u[cur_row] += minval before the other scanned rows, then the
// augmentation along `path`. Only adds and compares: there is nothing for
// FMA contraction to fuse, and the file is not built with fast math.
//
// What bounds it: a serial chain. Each problem runs at most M(M+1)/2
// dependent Dijkstra steps (row r's search scans at most r + 1 columns),
// each an argmin over N columns whose result picks the next row. The
// bytes (the costs once, the indices once: about 95 KB at P = 12,
// M = 32, N = 60) take 0.03 us at 3.35 TB/s, and the adds and compares
// about as little at the f32 rate, so the time is the chain's latency.
//
// Design: one thread block per problem (P blocks), threads over the N
// columns (32 * ceil(N / 32), a stride loop past 1024). The problem's
// costs, the duals u and v, sp, path, the scanned flags and both
// assignment maps live in shared memory (7.7 KB of costs at 32 x 60); the
// costs are read once through their strides, so the [P, N, M] cost that
// the matcher builds is solved as [P, M, N] without a transposing copy.
// Each Dijkstra step is one block-wide (value, column) argmin, lowest
// column on ties: warp shuffles, then one warp over the warps' results;
// two barriers a step. Each column's sp, path and scanned flag are
// written only by the thread that owns it, so the step needs no other
// barrier. The dual update runs over columns and rows in parallel, the
// augmentation serially in one thread. No atomics: the result is
// deterministic, and tensor-parallel ranks, which see the same costs,
// agree. The kernel allocates nothing and launches on the caller's
// stream.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;  // JAX's _INF
constexpr int kMaxThreads = 1024;
constexpr int kMaxShared = 232448;  // a block's opt-in maximum on sm_90

// (av, ai) before (bv, bi): the smaller value, the lower column on ties
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

__global__ void __launch_bounds__(kMaxThreads)
    lsa_rows_kernel(const float* __restrict__ cost, int64_t* __restrict__ out,
                    int M, int N, int64_t s0, int64_t s1, int64_t s2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* c = reinterpret_cast<float*>(smem);  // [M][N]
  float* v = c + (size_t)M * N;                // [N]
  float* sp = v + N;                           // [N]
  float* u = sp + N;                           // [M]
  int* path = reinterpret_cast<int*>(u + M);   // [N]
  int* row4col = path + N;                     // [N]
  int* col4row = row4col + N;                  // [M]
  unsigned char* SC = reinterpret_cast<unsigned char*>(col4row + M);  // [N]
  unsigned char* SR = SC + N;                                         // [M]
  __shared__ float warp_val[32];
  __shared__ int warp_col[32];
  __shared__ float min_val;
  __shared__ int min_col;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nt + 31) >> 5;
  const float* cp = cost + (int64_t)blockIdx.x * s0;
  for (int k = tid; k < M * N; k += nt) {
    const int r = k / N, j = k - r * N;
    c[k] = cp[(int64_t)r * s1 + (int64_t)j * s2];
  }
  for (int j = tid; j < N; j += nt) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  for (int r = tid; r < M; r += nt) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  __syncthreads();

  for (int cur = 0; cur < M; ++cur) {
    for (int j = tid; j < N; j += nt) {
      sp[j] = kInf;
      path[j] = -1;
      SC[j] = 0;
    }
    for (int r = tid; r < M; r += nt) SR[r] = 0;
    __syncthreads();

    // Dijkstra over reduced costs from row `cur` to a free column; i,
    // minval and sink are the same in every thread
    int i = cur, sink = -1;
    float minval = 0.f;
    while (true) {
      if (tid == 0) SR[i] = 1;
      const float ui = u[i];
      const float* ci = c + (size_t)i * N;
      float best = kInf;
      int bj = INT_MAX;
      for (int j = tid; j < N; j += nt) {
        float key = kInf;
        if (!SC[j]) {
          const float red = minval + ci[j] - ui - v[j];
          key = sp[j];
          if (red < key) {
            key = red;
            sp[j] = red;
            path[j] = i;
          }
        }
        if (before(key, j, best, bj)) {
          best = key;
          bj = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oj = __shfl_down_sync(0xffffffffu, bj, off);
        if (before(ov, oj, best, bj)) {
          best = ov;
          bj = oj;
        }
      }
      if (lane == 0) {
        warp_val[warp] = best;
        warp_col[warp] = bj;
      }
      __syncthreads();
      if (warp == 0) {
        best = lane < nwarps ? warp_val[lane] : kInf;
        bj = lane < nwarps ? warp_col[lane] : INT_MAX;
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, best, off);
          const int oj = __shfl_down_sync(0xffffffffu, bj, off);
          if (before(ov, oj, best, bj)) {
            best = ov;
            bj = oj;
          }
        }
        if (lane == 0) {
          min_val = best;
          min_col = bj;
        }
      }
      __syncthreads();
      const int j = min_col;
      minval = min_val;
      if (j % nt == tid) SC[j] = 1;  // the column's owner
      const int r = row4col[j];
      if (r < 0) {
        sink = j;
        break;
      }
      i = r;
    }
    __syncthreads();

    // dual updates: u[cur] += minval, then the other scanned rows, and
    // the scanned columns
    for (int r = tid; r < M; r += nt) {
      if (r == cur)
        u[r] = u[r] + minval;
      else if (SR[r])
        u[r] = u[r] + (minval - sp[col4row[r]]);
    }
    for (int j = tid; j < N; j += nt)
      if (SC[j]) v[j] = v[j] - (minval - sp[j]);
    __syncthreads();

    // augment along the alternating path ending at the sink
    if (tid == 0) {
      int j = sink;
      while (true) {
        const int r = path[j];
        row4col[j] = r;
        const int next = col4row[r];
        col4row[r] = j;
        if (r == cur) break;
        j = next;
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < M; r += nt)
    out[(int64_t)blockIdx.x * M + r] = col4row[r];
}

}  // namespace

extern "C" {

// cost [P, M, N] f32 at element strides (s0, s1, s2), out [P, M] int64
// contiguous. Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for sizes the kernel does not take.
int lsa_rows_f32(const void* cost, void* out, int64_t P, int64_t M,
                 int64_t N, int64_t s0, int64_t s1, int64_t s2,
                 void* stream) {
  if (P < 0 || M < 0 || N < M || N > INT_MAX / 2 || P > INT_MAX ||
      s0 < 0 || s1 < 0 || s2 < 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0 || M == 0) return (int)cudaSuccess;
  const int64_t smem =
      4 * (M * N + 2 * N + M) + 4 * (2 * N + M) + N + M;
  if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lsa_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t warps = (N + 31) / 32;
  const int threads = (int)(warps * 32 < kMaxThreads ? warps * 32
                                                     : kMaxThreads);
  lsa_rows_kernel<<<(unsigned)P, threads, (size_t)smem,
                    (cudaStream_t)stream>>>(
      static_cast<const float*>(cost), static_cast<int64_t*>(out), (int)M,
      (int)N, s0, s1, s2);
  return (int)cudaGetLastError();
}

}  // extern "C"
