// Dependent in-row gather and select chains for Hopper (sm_90a): K3 of the
// JAX package's TPU kernels.
//
// Replaces `probe_primitive`'s two Pallas kernels
// (scripts/lanegather_probe.py:89-127): `_chain_gather_kernel` (:69) and
// `_chain_select_kernel` (:78). Over rows of 128 f32 values x and
// int32 ids idx in [0, 128), n dependent steps each:
//
//   chain_gather:  x[j] = x[idx[j]] + 1
//   chain_select:  x[j] = x[j] + (idx[j] == j - (i % 2) ? x[j] : 0)   (step i)
//
// The TPU probe measures what Mosaic's in-tile lane gather costs per element
// against the compare + select + add that a one-hot build is made of. The
// card's counterpart of an in-tile lane gather is the warp shuffle: one warp
// holds a 128-wide row as 4 registers per lane (lane j holds columns j,
// 32 + j, 64 + j, 96 + j), and each gather step takes x[idx] by four
// __shfl_sync (one per register, at lane idx & 31) and a select on idx >> 5.
// Every step reads the previous step's result, so no step can be hoisted out
// of the chain. The select chain is the same warp layout with the compare,
// select and add in registers, unrolled by two so that each step compares
// with one of two targets held in registers (j and j - 1). It runs on a
// resident grid, as many blocks as fit on the card at once, and each warp
// loads its next row's x and idx into registers before it runs the current
// row's chain, so the loads hide behind the chain.
//
// What bounds them: the chain's instructions, not memory. Each launch must
// read x and idx once and write x once (50 MB at the probe's 64 x [512, 128]
// rows, 15 us at 3.35 TB/s).
// - chain_gather issues 16 shuffles a step per warp: 33.6 M warp shuffles
//   at that size, 0.128 ms at one warp shuffle a clock per SM on 132 SMs
//   at 1.98 GHz. It keeps its first design: the same grid and prefetch as
//   the select chain cost registers (48 a thread, 5 blocks an SM instead
//   of 6) and ran 7-8% slower, and shuffle rounds planned once per row
//   (per source register as many rounds as the most requests a lane has
//   for it, about 11.7 a step instead of 16) pay four compare-and-selects
//   a round to place each value in its slot and ran 4.5x slower
//   (PERF.md).
// - chain_select issues 3 operations per element and step, 12 warp
//   instructions a step: 25.2 M, 0.024 ms at 4 issues a clock per SM. The
//   compare and the select issue at 64 lanes a clock per SM, half the rate
//   of the add, which puts the floor nearer 0.032 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#define LC_THREADS 256
#define LC_ROW 128
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         const int* __restrict__ idx,
                                         int64_t r, int lane, float (&v)[4],
                                         int (&id)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = __ldg(x + r * LC_ROW + q * 32 + lane);
    id[q] = __ldg(idx + r * LC_ROW + q * 32 + lane) & (LC_ROW - 1);
  }
}

// n select steps; step i compares with column - (i % 2).
__device__ __forceinline__ void select_steps(float (&v)[4],
                                             const int (&id)[4], int n,
                                             int lane) {
  int t0[4], t1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    t0[q] = q * 32 + lane;
    t1[q] = t0[q] - 1;
  }
  int i = 0;
#pragma unroll 2
  for (; i + 1 < n; i += 2) {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = v[q] + (id[q] == t0[q] ? v[q] : 0.0f);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = v[q] + (id[q] == t1[q] ? v[q] : 0.0f);
  }
  if (i < n) {  // an odd n: the last step is even
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = v[q] + (id[q] == t0[q] ? v[q] : 0.0f);
  }
}

// chain_gather: one warp per 128-wide row on a grid of one block per 8
// rows (at most 65536 blocks, a grid-stride loop over the rest), each step
// 16 shuffles and a select on idx >> 5.
__global__ void __launch_bounds__(LC_THREADS)
chain_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                    float* __restrict__ out, int64_t rows, int n) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
       r < rows; r += nwarps) {
    float v[4];
    int id[4];
    load_row(x, idx, r, lane, v, id);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int src = id[q] & 31;
        const float g0 = __shfl_sync(FULL_MASK, v[0], src);
        const float g1 = __shfl_sync(FULL_MASK, v[1], src);
        const float g2 = __shfl_sync(FULL_MASK, v[2], src);
        const float g3 = __shfl_sync(FULL_MASK, v[3], src);
        const int reg = id[q] >> 5;
        g[q] = reg == 0 ? g0 : reg == 1 ? g1 : reg == 2 ? g2 : g3;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = g[q] + 1.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) out[r * LC_ROW + q * 32 + lane] = v[q];
  }
}

// chain_select: one warp per 128-wide row, rows in a grid-stride loop over
// the resident warps, each loading its next row while the current one runs.
__global__ void __launch_bounds__(LC_THREADS)
chain_select_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                    float* __restrict__ out, int64_t rows, int n) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  int64_t r = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  if (r >= rows) return;
  float nv[4];
  int ni[4];
  load_row(x, idx, r, lane, nv, ni);
  for (; r < rows; r += nwarps) {
    float v[4];
    int id[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = nv[q];
      id[q] = ni[q];
    }
    if (r + nwarps < rows) load_row(x, idx, r + nwarps, lane, nv, ni);
    select_steps(v, id, n, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) out[r * LC_ROW + q * 32 + lane] = v[q];
  }
}

// chain_gather: one block per 8 rows, at most 65536.
static int launch_gather(const void* x, const void* idx, void* out,
                         int64_t rows, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  int64_t blocks = (rows + LC_THREADS / 32 - 1) / (LC_THREADS / 32);
  if (blocks > 65536) blocks = 65536;  // the grid-stride loop covers the rest
  chain_gather_kernel<<<(unsigned)blocks, LC_THREADS, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, n);
  return (int)cudaGetLastError();
}

// chain_select: as many blocks as are resident on the card at once, or
// fewer where the rows do not fill them.
static int launch_select(const void* x, const void* idx, void* out,
                         int64_t rows, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chain_select_kernel, LC_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (rows + LC_THREADS / 32 - 1) / (LC_THREADS / 32);
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  chain_select_kernel<<<(unsigned)blocks, LC_THREADS, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, n);
  return (int)cudaGetLastError();
}

extern "C" {

// x [rows, 128] f32, idx [rows, 128] int32 in [0, 128) -> out [rows, 128]
// f32 after n steps. Return cudaGetLastError() after the launch.
int chain_gather_f32(const void* x, const void* idx, void* out, int64_t rows,
                     int n, void* stream) {
  return launch_gather(x, idx, out, rows, n, stream);
}

int chain_select_f32(const void* x, const void* idx, void* out, int64_t rows,
                     int n, void* stream) {
  return launch_select(x, idx, out, rows, n, stream);
}

}  // extern "C"
