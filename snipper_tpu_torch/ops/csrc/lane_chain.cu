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
// select and add in registers.
//
// What bounds them: the chain's instructions, not memory. Each launch must
// read x and idx once and write x once (50 MB at the probe's 64 x [512, 128]
// rows, 15 us at 3.35 TB/s); the gather chain issues 16 shuffles and 4
// selects per 4 elements and step, the select chain 3 operations per element
// and step.

#include <cuda_runtime.h>
#include <stdint.h>

#define LC_THREADS 256
#define FULL_MASK 0xffffffffu

// One warp per 128-wide row, rows in a grid-stride loop over warps.
template <bool kGather>
__global__ void __launch_bounds__(LC_THREADS)
lane_chain_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  float* __restrict__ out, int64_t rows, int n) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
       r < rows; r += nwarps) {
    float v[4];
    int id[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = x[r * 128 + q * 32 + lane];
      id[q] = idx[r * 128 + q * 32 + lane] & 127;
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      if constexpr (kGather) {
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
      } else {
        const int shift = i & 1;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = v[q] + (id[q] == q * 32 + lane - shift ? v[q] : 0.0f);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) out[r * 128 + q * 32 + lane] = v[q];
  }
}

template <bool kGather>
static int launch(const void* x, const void* idx, void* out, int64_t rows,
                  int n, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const int64_t warps_per_block = LC_THREADS / 32;
  int64_t blocks = (rows + warps_per_block - 1) / warps_per_block;
  if (blocks > 65536) blocks = 65536;  // the grid-stride loop covers the rest
  lane_chain_kernel<kGather><<<(unsigned)blocks, LC_THREADS, 0,
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
  return launch<true>(x, idx, out, rows, n, stream);
}

int chain_select_f32(const void* x, const void* idx, void* out, int64_t rows,
                     int n, void* stream) {
  return launch<false>(x, idx, out, rows, n, stream);
}

}  // extern "C"
